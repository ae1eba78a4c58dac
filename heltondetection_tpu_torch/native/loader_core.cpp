// The native data-loader core; the port's own copy of
// heltondetection_tpu/native/loader_core.cpp, with the same C ABI (hd_plan,
// hd_pool_*), so the plans data/native_loader.py builds are the reference's.
//
// One hd_pool_run(plans[]) call assembles a whole train or eval batch on a
// persistent C++ thread pool, outside the GIL: per sample it (optionally)
// decodes JPEGs (libjpeg), renders a letterbox or mosaic-4, applies the
// affine warp, HSV jitter and horizontal flip, writing in place into
// caller-owned batch slots. Pixel math is OpenCV's, in the reference's call
// sequence, so the port's native batches equal the reference's native
// batches bit for bit (tests/test_torch_port_native_loader.py). The port's
// Python pipelines (data/augment.py) are not OpenCV and differ from these by
// a few grey levels.
//
// Host code: g++ builds it at first use into the package's _build/
// (native/__init__.py), where the OpenCV (core, imgproc) and libjpeg
// development files are installed.
//
// The Python side (data/native_loader.py) draws the per-sample random
// parameters and transforms the (tiny) box arrays.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <mutex>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, same decoder family cv2.imdecode wraps — output is
// bit-identical, pinned by tests). No EXIF handling: callers route
// EXIF-oriented files through the decoded path (see data/native_loader.py).
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

int jpeg_dims(const uint8_t* data, size_t len, int* oh, int* ow) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *oh = cinfo.image_height;
  *ow = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// returns 0 on success; out must hold cap bytes; fills *oh, *ow (RGB order).
int decode_jpeg(const uint8_t* data, size_t len, uint8_t* out, size_t cap,
                int* oh, int* ow) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // YCbCr / grayscale → RGB in-decoder
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if ((size_t)w * h * 3 > cap || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *oh = h;
  *ow = w;
  return 0;
}

// ---------------------------------------------------------------------------
// pixel ops — each mirrors one augment.py call exactly

// Python round() semantics (half-to-even). std::lround rounds half away
// from zero, which disagrees with the numpy/Python box math whenever
// w*scale lands exactly on .5 — a 1-px tile size/offset skew vs the labels.
// nearbyint under the default FE_TONEAREST mode is round-half-to-even.
static inline int py_round(double x) { return (int)std::nearbyint(x); }

// letterbox_np: aspect-preserving cv2.resize + centered 114-pad
void letterbox(const cv::Mat& src, cv::Mat& dst /*S×S×3, prealloc*/,
               uint8_t pad) {
  const int S = dst.rows;
  double scale = std::min((double)S / src.rows, (double)S / src.cols);
  int nw = py_round(src.cols * scale);
  int nh = py_round(src.rows * scale);
  dst.setTo(cv::Scalar(pad, pad, pad));
  cv::Mat roi = dst(cv::Rect((S - nw) / 2, (S - nh) / 2, nw, nh));
  if (nw == src.cols && nh == src.rows)
    src.copyTo(roi);
  else
    cv::resize(src, roi, cv::Size(nw, nh), 0, 0, cv::INTER_LINEAR);
}

// mosaic4: augment.mosaic4's placement arithmetic. Each tile is resized with
// the same cv::resize call the Python path makes (bit-identical pixels);
// only the intersection of its canvas placement with the center-crop window
// [off, off+S) is copied into the output — no 2S×2S canvas.
void mosaic4(const cv::Mat src[4], int n_tiles, cv::Mat& dst, int xc, int yc,
             uint8_t pad, cv::Mat& tile_buf) {
  const int S = dst.rows;
  const int off = S / 2;
  dst.setTo(cv::Scalar(pad, pad, pad));
  for (int i = 0; i < n_tiles && i < 4; ++i) {
    if (src[i].empty()) continue;
    const int h = src[i].rows, w = src[i].cols;
    double scale = std::min((double)S / h, (double)S / w);
    int nw = py_round(w * scale);
    int nh = py_round(h * scale);
    cv::Mat tile;
    if (nw == w && nh == h) {
      tile = src[i];
    } else {
      cv::resize(src[i], tile_buf, cv::Size(nw, nh), 0, 0, cv::INTER_LINEAR);
      tile = tile_buf;
    }
    int x1a, y1a, x2a, y2a, x1b, y1b;
    if (i == 0) {
      x1a = std::max(xc - nw, 0); y1a = std::max(yc - nh, 0);
      x2a = xc; y2a = yc;
      x1b = nw - (x2a - x1a); y1b = nh - (y2a - y1a);
    } else if (i == 1) {
      x1a = xc; y1a = std::max(yc - nh, 0);
      x2a = std::min(xc + nw, 2 * S); y2a = yc;
      x1b = 0; y1b = nh - (y2a - y1a);
    } else if (i == 2) {
      x1a = std::max(xc - nw, 0); y1a = yc;
      x2a = xc; y2a = std::min(yc + nh, 2 * S);
      x1b = nw - (x2a - x1a); y1b = 0;
    } else {
      x1a = xc; y1a = yc;
      x2a = std::min(xc + nw, 2 * S); y2a = std::min(yc + nh, 2 * S);
      x1b = 0; y1b = 0;
    }
    // canvas placement ∩ crop window, in output coordinates
    int gx1 = std::max(x1a, off), gy1 = std::max(y1a, off);
    int gx2 = std::min(x2a, off + S), gy2 = std::min(y2a, off + S);
    if (gx1 >= gx2 || gy1 >= gy2) continue;
    cv::Rect src_r(x1b + (gx1 - x1a), y1b + (gy1 - y1a), gx2 - gx1,
                   gy2 - gy1);
    cv::Rect dst_r(gx1 - off, gy1 - off, gx2 - gx1, gy2 - gy1);
    tile(src_r).copyTo(dst(dst_r));
  }
}

// random_hsv: identical tables to augment.random_hsv (numpy truncation),
// applied as ONE 3-channel LUT between the two cvtColors.
void hsv_jitter(cv::Mat& img, cv::Mat& hsv_buf, double r0, double r1,
                double r2) {
  uint8_t lut[256 * 3];
  for (int x = 0; x < 256; ++x) {
    double hh = std::fmod(x * r0, 180.0);
    if (hh < 0) hh += 180.0;
    lut[x * 3 + 0] = (uint8_t)hh;                                   // H
    lut[x * 3 + 1] = (uint8_t)std::min(std::max(x * r1, 0.0), 255.0);  // S
    lut[x * 3 + 2] = (uint8_t)std::min(std::max(x * r2, 0.0), 255.0);  // V
  }
  cv::Mat lut_mat(1, 256, CV_8UC3, lut);
  cv::cvtColor(img, hsv_buf, cv::COLOR_RGB2HSV);
  cv::LUT(hsv_buf, lut_mat, hsv_buf);
  cv::cvtColor(hsv_buf, img, cv::COLOR_HSV2RGB);
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
extern "C" {

typedef struct {
  const uint8_t* src[4];   // decoded RGB tiles (tile 0 = letterbox source)
  int sh[4], sw[4];
  const uint8_t* jpeg[4];  // optional: raw JPEG bytes, decoded in-pool
  long long jlen[4];
  int n_tiles;             // 1 (letterbox) or 4 (mosaic)
  int mode;                // 0 = letterbox, 1 = mosaic
  int S;                   // output size (out is S*S*3)
  int xc, yc;              // mosaic center on the virtual 2S canvas
  int do_affine;
  double m[6];             // FORWARD affine matrix (cv2.warpAffine semantics)
  int do_hsv;
  double r0, r1, r2;
  int do_flip;
  int pad_value;
  uint8_t* out;
  int status;              // 0 ok; 1 jpeg decode failure; 2 no pixel
                           // source; 3 caught native exception;
                           // 4 bitstream dims disagree with annotation
                           // metadata (mirrors Python _PLAN_ERRORS)
} hd_plan;

namespace {

struct Workspace {  // per-thread scratch, grow-only
  std::vector<uint8_t> dec[4];
  cv::Mat tile_buf, scratch, hsv_buf;
};

void run_plan(hd_plan* p, Workspace& ws) {
  p->status = 0;
  const int S = p->S;
  const int nt = p->mode == 1 ? std::min(p->n_tiles, 4) : 1;
  cv::Mat srcs[4];
  for (int i = 0; i < nt; ++i) {
    if (p->src[i]) {
      srcs[i] = cv::Mat(p->sh[i], p->sw[i], CV_8UC3,
                        const_cast<uint8_t*>(p->src[i]));
    } else if (p->jpeg[i] && p->jlen[i] > 0) {
      int h = 0, w = 0;
      if (jpeg_dims(p->jpeg[i], (size_t)p->jlen[i], &h, &w) != 0 || h <= 0 ||
          w <= 0) {
        p->status = 1;
        return;
      }
      // the caller computed box/letterbox math from sh/sw (annotation
      // metadata); a mismatch with the actual bitstream (mis-annotated or
      // EXIF-rotated file) would silently misalign labels — reject it
      if (p->sh[i] > 0 && p->sw[i] > 0 &&
          (p->sh[i] != h || p->sw[i] != w)) {
        p->status = 4;
        return;
      }
      if (ws.dec[i].size() < (size_t)h * w * 3)
        ws.dec[i].resize((size_t)h * w * 3);
      if (decode_jpeg(p->jpeg[i], (size_t)p->jlen[i], ws.dec[i].data(),
                      ws.dec[i].size(), &h, &w)) {
        p->status = 1;
        return;
      }
      srcs[i] = cv::Mat(h, w, CV_8UC3, ws.dec[i].data());
    } else {
      p->status = 2;
      return;
    }
  }
  cv::Mat out(S, S, CV_8UC3, p->out);
  cv::Mat* target = &out;
  if (p->do_affine) {  // render into scratch, warp into out
    ws.scratch.create(S, S, CV_8UC3);
    target = &ws.scratch;
  }
  if (p->mode == 1)
    mosaic4(srcs, nt, *target, p->xc, p->yc, (uint8_t)p->pad_value,
            ws.tile_buf);
  else
    letterbox(srcs[0], *target, (uint8_t)p->pad_value);
  if (p->do_affine) {
    cv::Mat M(2, 3, CV_64F, p->m);
    cv::warpAffine(*target, out, M, cv::Size(S, S), cv::INTER_LINEAR,
                   cv::BORDER_CONSTANT,
                   cv::Scalar(p->pad_value, p->pad_value, p->pad_value));
  }
  if (p->do_hsv) hsv_jitter(out, ws.hsv_buf, p->r0, p->r1, p->r2);
  if (p->do_flip) cv::flip(out, out, 1);
}

}  // namespace

// ---- persistent thread pool -----------------------------------------------
struct hd_pool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_start, cv_done;
  hd_plan* plans = nullptr;
  int n_plans = 0;
  // work tickets are GENERATION-TAGGED: (generation << 32) | next_index.
  // A worker claims an index with a CAS that fails if hd_pool_run has
  // already published the next batch — otherwise a straggler between its
  // last done++ and next claim could steal index 0 of the new batch while
  // holding stale plans/n_plans reads (silently-unrun plan slot).
  std::atomic<uint64_t> ticket{0};
  std::atomic<int> done{0};
  uint64_t generation = 0;
  bool stop = false;

  void worker() {
    Workspace ws;
    uint64_t seen = 0;
    for (;;) {
      int n;
      hd_plan* batch;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_start.wait(lk, [&] { return stop || generation != seen; });
        if (stop) return;
        seen = generation;
        n = n_plans;
        batch = plans;
      }
      for (;;) {
        uint64_t t = ticket.load(std::memory_order_acquire);
        // compare the TRUNCATED tags: the store keeps only 32 generation
        // bits, so masking `seen` avoids a permanent mismatch (and a
        // silent hd_pool_run hang) after 2^32 batches on one pool
        if ((t >> 32) != (seen & 0xffffffffu)) break;  // next batch published
        int i = (int)(t & 0xffffffffu);
        if (i >= n) break;
        if (!ticket.compare_exchange_weak(t, t + 1,
                                          std::memory_order_acq_rel))
          continue;
        // exception barrier: a cv::Exception escaping a std::thread would
        // std::terminate the whole process; surface it as a plan status
        try {
          run_plan(&batch[i], ws);
        } catch (...) {
          batch[i].status = 3;
        }
        if (done.fetch_add(1) + 1 == n) {
          std::lock_guard<std::mutex> lk(mu);
          cv_done.notify_all();
        }
      }
    }
  }
};

void* hd_pool_create(int n_threads) {
  cv::setNumThreads(0);  // pool threads each run single-threaded cv ops
  auto* p = new hd_pool();
  int n = std::max(1, n_threads);
  p->threads.reserve(n);
  for (int i = 0; i < n; ++i)
    p->threads.emplace_back([p] { p->worker(); });
  return p;
}

void hd_pool_destroy(void* pool) {
  auto* p = (hd_pool*)pool;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_start.notify_all();
  }
  for (auto& t : p->threads) t.join();
  delete p;
}

// blocking: runs all plans on the pool, returns when the batch is assembled.
// NOT reentrant: the Python side serializes calls per pool (NativePool.run).
void hd_pool_run(void* pool, hd_plan* plans, int n) {
  auto* p = (hd_pool*)pool;
  if (n <= 0) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->plans = plans;
    p->n_plans = n;
    p->done.store(0);
    p->generation++;
    // publish the new generation's ticket LAST: stale claims CAS-fail
    p->ticket.store(p->generation << 32, std::memory_order_release);
    p->cv_start.notify_all();
  }
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->done.load() >= n; });
}

// ---- single-call entry points (tests + ad-hoc use) -------------------------
void hd_run_plan(hd_plan* plan) {
  Workspace ws;
  try {
    run_plan(plan, ws);
  } catch (...) {
    plan->status = 3;
  }
}

void hd_letterbox(const uint8_t* src, int sh, int sw, uint8_t* dst, int S,
                  int pad) {
  cv::Mat s(sh, sw, CV_8UC3, const_cast<uint8_t*>(src));
  cv::Mat d(S, S, CV_8UC3, dst);
  letterbox(s, d, (uint8_t)pad);
}

void hd_hsv_jitter(uint8_t* img, int h, int w, double r0, double r1,
                   double r2) {
  cv::Mat m(h, w, CV_8UC3, img);
  cv::Mat buf;
  hsv_jitter(m, buf, r0, r1, r2);
}

void hd_flip_h(uint8_t* img, int h, int w) {
  cv::Mat m(h, w, CV_8UC3, img);
  cv::flip(m, m, 1);
}

int hd_jpeg_dims(const uint8_t* data, long long len, int* oh, int* ow) {
  return jpeg_dims(data, (size_t)len, oh, ow);
}

int hd_decode_jpeg(const uint8_t* data, long long len, uint8_t* out,
                   long long cap, int* oh, int* ow) {
  return decode_jpeg(data, (size_t)len, out, (size_t)cap, oh, ow);
}

}  // extern "C"
