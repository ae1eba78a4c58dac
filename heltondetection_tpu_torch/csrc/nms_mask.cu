// Exact greedy NMS keep mask for Hopper (sm_90a), any N a multiple of 64: a
// tiled bitmask build over the whole card, then one warp's greedy scan per
// image, register-resident up to N = 16384 and with its state in shared
// memory above.
//
// Replaces heltondetection_tpu/ops/nms.py:nms_mask_pallas (the Pallas body
// _nms_kernel). Input: score-sorted boxes (B, N, 4) f32 xyxy with the class
// offset already added, N a multiple of 64, zero rows as inert padding;
// output: keep (B, N) as 0/1 bytes. Box j is suppressed iff some kept box
// i < j has
//     inter > thr * (area_i + area_j - inter + 1e-7)
// the predicate of both Pallas kernels and of nms_fixpoint.cu.
//
// Design. The Pallas kernel materialises the (N, N) thresholded matrix in
// VMEM and then runs the sequential row scan in the same program. Here the
// matrix is a bitmask in device memory (scratch the wrapper allocates,
// N*N/8 bytes per image: 128 KB at N = 1024, 512 KB at N = 2048), built by
// the first kernel over a (column tile, row tile, image) grid of 64 x 64
// tiles. A block stages its 64 column boxes in shared memory; each of its
// 64 threads tests one row box against them and writes one uint64 word.
// Tiles below the diagonal are never read and are not written; on the
// diagonal tile only j > i is set. Read as 32-bit words (little-endian),
// uint64 word c of a row is its 32-bit words 2c and 2c + 1, the layout of
// nms_scan.cuh. The second kernel is one warp per image running
// nms::greedy_scan: it keeps `removed` in registers, resolves each 32-row
// block's diagonal in one lane, and ORs the kept rows in, with each unit's
// 32 row words loaded from L2 (__ldcg) two units ahead. It reads only words
// at or right of a block's diagonal word, all of which the build wrote.
//
// Past N = 16384 the lanes' registers cannot hold `removed` (16 words a
// lane), so nms_mask_scan_shared_kernel keeps it in shared memory, N / 8
// bytes (8 KB at N = 65536), and runs the same units in the same order
// (nms::greedy_scan_shared) over the same global bitmask. What bounds N then
// is the bitmask the wrapper allocates, N^2 / 8 bytes per image (34 MB at
// N = 16448, 512 MB at N = 65536); the shared words would allow N up to
// about 1.8 million.
//
// Why not nms_fixpoint.cu: that kernel keeps the whole bitmask in the
// shared memory of one cluster of four blocks, which caps it at N <= 2400.
// This one spreads the O(N^2) tests over every SM (FasterRCNN's final NMS
// runs at N = 2048, its RPN NMS at 1024 per level).
//
// Bound on this card. N*(N-1)/2 pairwise tests of 14 f32 operations per
// image against 16*N bytes read and N written: operations bound it, about
// 0.11 us per image at N = 1024. That bound counts every operation at the
// FMA rate and ignores the scan, a chain of N dependent steps per image
// (3 dependent instructions per row in the diagonal, plus each unit's ORs
// and loads) that no number of SMs shortens. On an H100 the build takes
// about 24 us at B = 32 N = 1024 or B = 8 N = 2048, the scan about 20 us at
// N = 1024 and 53 us at N = 2048: the scan sets the time at N = 2048.
//
// Rounding. Every operation of the predicate is written with an _rn
// intrinsic (and the build passes --fmad=false), so no multiply-add is
// contracted and the mask equals the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_scan.cuh"

namespace {

constexpr int kTile = 64;        // boxes per build tile side = bits per word
constexpr int kMaxSlots = 16;    // removed words per lane: N <= 32*32*16
constexpr int kScanAhead = 2;    // units in flight, for L2's latency

// grid (N/64 column tiles, N/64 row tiles, B), block 64: mask[b][i][c] bit
// k = row i suppresses column c*64 + k.
__global__ void __launch_bounds__(kTile)
nms_mask_build_kernel(const float4* __restrict__ boxes,
                      unsigned long long* __restrict__ mask, int n,
                      float thr) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;   // below the diagonal: never read
  const int words = n / kTile;
  const float4* img = boxes + static_cast<size_t>(blockIdx.z) * n;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  const float4 cb = img[col_tile * kTile + threadIdx.x];
  col_box[threadIdx.x] = cb;
  col_area[threadIdx.x] = nms::area_of(cb);
  __syncthreads();

  const int i = row_tile * kTile + threadIdx.x;
  const float4 bi = img[i];
  const float ai = nms::area_of(bi);
  const int first = col_tile == row_tile ? threadIdx.x + 1 : 0;
  unsigned long long bits = 0ull;
  for (int k = first; k < kTile; ++k) {
    if (nms::suppresses(bi, ai, col_box[k], col_area[k], thr))
      bits |= 1ull << k;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + i) * words + col_tile] = bits;
}

// One image's rows in device memory, `words` 32-bit words each.
struct GlobalRows {
  const uint32_t* __restrict__ mask;
  int words;
  __device__ __forceinline__ void load(int blk, int w,
                                       uint32_t (&buf)[32]) const {
    const uint32_t* p =
        mask + (static_cast<size_t>(blk) << 5) * words + w;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      buf[k] = __ldcg(p + static_cast<size_t>(k) * words);
  }
};

// grid B, block 32 (one warp per image).
template <int WPL>
__global__ void __launch_bounds__(32)
nms_mask_scan_kernel(const uint32_t* __restrict__ mask,
                     uint8_t* __restrict__ keep, int n) {
  const int words = n >> 5;
  const GlobalRows rows{mask + static_cast<size_t>(blockIdx.x) * n * words,
                        words};
  uint32_t removed[WPL];
  nms::greedy_scan<WPL, kScanAhead>(rows, words, removed);
  nms::write_keep<WPL>(removed, words,
                       keep + static_cast<size_t>(blockIdx.x) * n);
}

// grid B, block 32: the scan with `removed` in dynamic shared memory,
// slots * 32 words.
__global__ void __launch_bounds__(32)
nms_mask_scan_shared_kernel(const uint32_t* __restrict__ mask,
                            uint8_t* __restrict__ keep, int n, int slots) {
  extern __shared__ uint32_t removed[];
  const int words = n >> 5;
  const GlobalRows rows{mask + static_cast<size_t>(blockIdx.x) * n * words,
                        words};
  nms::greedy_scan_shared(rows, words, slots, removed);
  uint8_t* out = keep + static_cast<size_t>(blockIdx.x) * n;
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (int w = lane; w < words; w += 32)
    nms::store_keep_word(removed[w], w, out);
}

template <int WPL>
cudaError_t launch_scan(const void* mask, void* keep, int batch, int n,
                        cudaStream_t s) {
  nms_mask_scan_kernel<WPL><<<batch, 32, 0, s>>>(
      static_cast<const uint32_t*>(mask), static_cast<uint8_t*>(keep), n);
  return cudaGetLastError();
}

cudaError_t launch_scan_shared(const void* mask, void* keep, int batch, int n,
                               int slots, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(slots) * 32 * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_mask_scan_shared_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  nms_mask_scan_shared_kernel<<<batch, 32, bytes, s>>>(
      static_cast<const uint32_t*>(mask), static_cast<uint8_t*>(keep), n,
      slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the scan takes on `device`: its removed words must fit a block's
// shared memory (the build's grid takes N up to 64 * 65535, more). Negative:
// a CUDA error code, negated.
long long nms_mask_max_n(int device) {
  int smem = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long slots = smem / (32 * sizeof(uint32_t));
  const long long n = slots * 32 * 32;
  const long long grid_n = static_cast<long long>(kTile) * 65535;
  return n < grid_n ? n : grid_n;
}

// Launches the build over the (B, N, N/64) uint64 scratch `mask`, then the
// scan, both on `stream`; returns the CUDA error code. Only the shared-memory
// scan above 48 KB of words (N > 393216) needs a launch attribute, set here.
int nms_mask_launch(const void* boxes, void* mask, void* keep, int batch,
                    int n, float iou_thres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = n / kTile;
  nms_mask_build_kernel<<<dim3(tiles, tiles, batch), kTile, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), n, iou_thres);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = n >> 5;
  const int slots = (words + 31) >> 5;
  if (slots <= 1) return launch_scan<1>(mask, keep, batch, n, s);
  if (slots <= 2) return launch_scan<2>(mask, keep, batch, n, s);
  if (slots <= 4) return launch_scan<4>(mask, keep, batch, n, s);
  if (slots <= 8) return launch_scan<8>(mask, keep, batch, n, s);
  if (slots <= kMaxSlots)
    return launch_scan<kMaxSlots>(mask, keep, batch, n, s);
  return static_cast<int>(launch_scan_shared(mask, keep, batch, n, slots, s));
}

const char* nms_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
