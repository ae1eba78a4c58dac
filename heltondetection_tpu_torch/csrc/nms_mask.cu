// Exact greedy NMS keep mask for Hopper (sm_90a), any N: a tiled bitmask
// build over the whole card, then one warp's greedy scan per image.
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
// diagonal tile only j > i is set. The second kernel is one warp per image:
// it copies 32 rows of the mask at a time into shared memory (all the
// loads of a chunk in flight at once), then walks the rows in order and
// ORs each kept row into the `removed` words, also in shared memory.
//
// Why not nms_fixpoint.cu: that kernel keeps the whole bitmask in one
// block's shared memory, which caps it at N <= 1280 and one SM per image.
// This one takes any N the scratch allows (FasterRCNN's final NMS runs at
// N = 2048) and spreads the O(N^2) tests over every SM.
//
// Bound on this card. N*(N-1)/2 pairwise tests of 14 f32 operations per
// image against 16*N bytes read and N written: operations bound it, about
// 0.11 us per image at N = 1024. The scan is a chain of N dependent
// shared-memory steps per image and the mask makes a round trip through
// L2; both are what a faster version would attack.
//
// Rounding. Every operation of the predicate is written with an _rn
// intrinsic (and the build passes --fmad=false), so no multiply-add is
// contracted and the mask equals the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // boxes per tile side = bits per word
constexpr int kChunk = 32;       // mask rows staged per scan step

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  const float iw =
      fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih =
      fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return inter > __fmul_rn(thr, uni);
}

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
  col_area[threadIdx.x] = area_of(cb);
  __syncthreads();

  const int i = row_tile * kTile + threadIdx.x;
  const float4 bi = img[i];
  const float ai = area_of(bi);
  const int first = col_tile == row_tile ? threadIdx.x + 1 : 0;
  unsigned long long bits = 0ull;
  for (int k = first; k < kTile; ++k) {
    if (suppresses(bi, ai, col_box[k], col_area[k], thr)) bits |= 1ull << k;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + i) * words + col_tile] = bits;
}

// grid B, block 32 (one warp per image).
__global__ void __launch_bounds__(32)
nms_mask_scan_kernel(const unsigned long long* __restrict__ mask,
                     uint8_t* __restrict__ keep, int n) {
  extern __shared__ unsigned long long smem[];
  const int words = n / kTile;
  unsigned long long* removed = smem;               // words
  unsigned long long* chunk = smem + words;         // kChunk x words
  const int lane = threadIdx.x;
  const unsigned long long* img_mask =
      mask + static_cast<size_t>(blockIdx.x) * n * words;

  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();

  for (int r0 = 0; r0 < n; r0 += kChunk) {
    // the chunk's rows all sit in row tile r0 / 64, so words from there on
    // were written by the build; the ones left of it are not read
    const int w0 = r0 / kTile;
    const int span = words - w0;
    for (int idx = lane; idx < kChunk * span; idx += 32) {
      const int r = idx / span;
      const int w = w0 + idx - r * span;
      chunk[r * words + w] = img_mask[static_cast<size_t>(r0 + r) * words + w];
    }
    __syncwarp();
    for (int r = 0; r < kChunk; ++r) {
      const int i = r0 + r;
      const int wi = i / kTile;
      const bool gone = (removed[wi] >> (i % kTile)) & 1ull;  // warp-uniform
      __syncwarp();
      if (!gone) {
        for (int w = wi + lane; w < words; w += 32)
          removed[w] |= chunk[r * words + w];
      }
      __syncwarp();
    }
  }

  uint8_t* out = keep + static_cast<size_t>(blockIdx.x) * n;
  for (int i = lane; i < n; i += 32)
    out[i] = ((removed[i / kTile] >> (i % kTile)) & 1ull) ? 0 : 1;
}

size_t scan_smem_bytes(int n) {
  const size_t words = static_cast<size_t>(n) / kTile;
  return (words + kChunk * words) * sizeof(unsigned long long);
}

}  // namespace

extern "C" {

// Shared memory the scan's block needs for n boxes (n a multiple of 64).
long long nms_mask_smem_bytes(int n) {
  return static_cast<long long>(scan_smem_bytes(n));
}

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
long long nms_mask_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Launches the build over the (B, N, N/64) uint64 scratch `mask`, then the
// scan, both on `stream`; returns the CUDA error code.
int nms_mask_launch(const void* boxes, void* mask, void* keep, int batch,
                    int n, float iou_thres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = n / kTile;
  nms_mask_build_kernel<<<dim3(tiles, tiles, batch), kTile, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), n, iou_thres);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = scan_smem_bytes(n);
  err = cudaFuncSetAttribute(nms_mask_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_scan_kernel<<<batch, 32, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<uint8_t*>(keep), n);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
