// Pairwise IoU matrix of xyxy boxes for Hopper (sm_90a).
//
// Replaces heltondetection_tpu/ops/boxes.py:iou_matrix_pallas (the tile
// kernel inside it). Input: boxes a (N, 4) and b (M, 4) f32 xyxy; output:
// iou (N, M) f32, iou[i][j] = inter / (area_a + area_b - inter + 1e-7).
//
// Bound on this card. Each output costs 13 f32 operations against 4 bytes
// written, far below the card's 20 operations per byte of f32 rate over
// HBM rate, so the (N, M) store bounds it: (4*N*M + 16*(N+M)) bytes over
// 3.35 TB/s, 31 us at N = 1024, M = 25200.
//
// Design. The Pallas kernel emits one (256, 512) tile per grid step, with
// the boxes coordinate-major so each pairwise op is a (sublane, lane)
// broadcast. Here a block of 32 x 8 threads owns a 32-row, 128-column tile:
// it stages the tile's 32 row boxes and 128 column boxes (and their areas)
// in shared memory once, and each thread computes 16 outputs, rows
// ty + 8k and columns tx + 32l. A warp is one row of 32 neighbouring
// columns, so every store is one coalesced 128-byte line. The ragged edge
// is masked in the kernel, so N and M may be anything; the Pallas kernel
// needs multiples of 8 and 128.
//
// Rounding. Every operation is written with an _rn intrinsic, in the order
// of the plain PyTorch box_iou_matrix, and the division is IEEE; the build
// passes --fmad=false. The result equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // tile rows = 4 passes of blockDim.y
constexpr int kCols = 128;     // tile columns = 4 passes of a warp
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ out, int n, int m) {
  __shared__ float4 row_box[kRows];
  __shared__ float row_area[kRows];
  __shared__ float4 col_box[kCols];
  __shared__ float col_area[kCols];

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if (tid < kRows) {
    const int i = row0 + tid;
    const float4 box = i < n ? a[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    row_box[tid] = box;
    row_area[tid] = area_of(box);
  }
  if (tid < kCols) {
    const int j = col0 + tid;
    const float4 box = j < m ? b[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    col_box[tid] = box;
    col_area[tid] = area_of(box);
  }
  __syncthreads();

#pragma unroll
  for (int r = threadIdx.y; r < kRows; r += kThreadsY) {
    const int i = row0 + r;
    if (i >= n) break;
    const float4 p = row_box[r];
    const float ap = row_area[r];
    float* orow = out + static_cast<size_t>(i) * m;
#pragma unroll
    for (int c = threadIdx.x; c < kCols; c += kThreadsX) {
      const int j = col0 + c;
      if (j >= m) break;
      const float4 q = col_box[c];
      const float iw =
          fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float den =
          __fadd_rn(__fsub_rn(__fadd_rn(ap, col_area[c]), inter), kEps);
      orow[j] = __fdiv_rn(inter, den);
    }
  }
}

}  // namespace

extern "C" {

// Launches the (N, M) IoU matrix on `stream`; returns the CUDA error code.
int iou_matrix_launch(const void* a, const void* b, void* out, int n, int m,
                      void* stream) {
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  const dim3 block(kThreadsX, kThreadsY);
  iou_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* iou_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
