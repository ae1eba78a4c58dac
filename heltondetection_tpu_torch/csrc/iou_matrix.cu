// Pairwise IoU matrix of xyxy boxes for Hopper (sm_90a).
//
// Replaces heltondetection_tpu/ops/boxes.py:iou_matrix_pallas (the tile
// kernel inside it). Input: boxes a (N, 4) and b (M, 4) f32 xyxy; output:
// iou (N, M) f32, iou[i][j] = inter / (area_a + area_b - inter + 1e-7).
//
// Bound on this card. Each output costs 13 f32 operations against 4 bytes
// written, far below the card's 20 operations per byte of f32 rate over
// HBM rate, so the (N, M) store bounds it: (4*N*M + 16*(N+M)) bytes over
// 3.35 TB/s, 31 us at N = 1024, M = 25200. The IEEE division makes each
// output about 28 instructions, so the rate at which the schedulers hand
// out instructions is a second bound of nearly the same size (about 24 us
// there): the inner loop carries nothing but the arithmetic and the store.
//
// Design. The Pallas kernel emits one (256, 512) tile per grid step, with
// the boxes coordinate-major so each pairwise op is a (sublane, lane)
// broadcast. Here the unit of work is a warp's tile of 16 rows by 128
// columns, and the tiles are dealt to the warps of a one-dimensional grid,
// neighbouring warps on neighbouring column tiles. Each lane owns four
// columns: it loads their boxes once and keeps the 16 coordinates and 4
// areas in registers. The warp stages its 16 row boxes and areas in shared
// memory, and each lane walks down the rows: one broadcast read of the
// row's box and area, four outputs, and a streaming store (st.global.cs:
// the matrix is written once and never read here, so it should not stay
// in L2). There is no column load in the loop, and a tile that lies
// wholly inside the matrix runs a loop with no edge test. A lane's four
// divisions are one dependent chain after another, so it is the number of
// warps in flight that hides their latency: short tiles (16 rows, not 64
// or 128) measured fastest, most of all for a tall narrow matrix, which
// has few column tiles.
//
// Two stores. When M is a multiple of 4 every row of the output starts on
// a 16-byte boundary: a lane owns columns 4*lane .. 4*lane+3 and writes
// them as one float4, 512 contiguous bytes per warp and instruction, and
// a lane is wholly inside or wholly outside the matrix. For any other M a
// lane owns columns lane, lane+32, lane+64 and lane+96 and writes four
// floats, each instruction one contiguous 128-byte run of the warp. The
// caller says which (`vec`); the vector kernel must not be launched with
// M % 4 != 0.
//
// Rounding. Every operation is written with an _rn intrinsic, in the order
// of the plain PyTorch box_iou_matrix, and the division is IEEE; the build
// passes --fmad=false. The result equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 16;    // rows a warp walks down
constexpr int kTileCols = 128;   // 32 lanes x 4 columns
constexpr int kWarps = 4;        // warps (tiles) per block
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou_of(float4 p, float ap, float4 q,
                                        float aq) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(ap, aq), inter), kEps);
  // A zero numerator sends __fdiv_rn down its slow path (a call of some
  // hundred instructions), and most pairs of boxes do not overlap: divide
  // 1 instead and hand back the zero itself (0 / den is that zero).
  const bool some = inter != 0.0f;
  const float quot = __fdiv_rn(some ? inter : 1.0f, den);
  return some ? quot : inter;
}

// One warp's tile: rows row0 .. row0+rows-1, columns col0 .. col0+127.
// kFull: the tile lies inside the matrix (rows == kTileRows, every column
// < m), so nothing is tested.
template <bool kVec, bool kFull>
__device__ __forceinline__ void warp_tile(
    const float4* __restrict__ row_box, const float* __restrict__ row_area,
    const float4* __restrict__ b, float* __restrict__ out, int row0, int rows,
    int col0, int m, int lane) {
  int col[4];
  float4 q[4];
  float aq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = col0 + (kVec ? 4 * lane + k : lane + 32 * k);
    q[k] = (kFull || col[k] < m) ? __ldg(b + col[k])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    aq[k] = area_of(q[k]);
  }
  float* optr = out + static_cast<size_t>(row0) * m + col[0];
  const int n_rows = kFull ? kTileRows : rows;
#pragma unroll 4
  for (int r = 0; r < n_rows; ++r) {
    const float4 p = row_box[r];
    const float ap = row_area[r];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = iou_of(p, ap, q[k], aq[k]);
    if (kVec) {
      // m % 4 == 0: the lane's four columns are all inside or all outside
      if (kFull || col[0] < m)
        __stcs(reinterpret_cast<float4*>(optr),
               make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (kFull || col[k] < m) __stcs(optr + 32 * k, v[k]);
    }
    optr += m;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ out, int n, int m, int col_tiles,
                  long long tiles) {
  __shared__ float4 row_box[kWarps][kTileRows];
  __shared__ float row_area[kWarps][kTileRows];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (tile >= tiles) return;          // a whole warp; no block barrier below
  const int row0 = static_cast<int>(tile / col_tiles) * kTileRows;
  const int col0 = static_cast<int>(tile % col_tiles) * kTileCols;
  const int rows = min(kTileRows, n - row0);

  for (int r = lane; r < rows; r += 32) {
    const float4 box = __ldg(a + row0 + r);
    row_box[warp][r] = box;
    row_area[warp][r] = area_of(box);
  }
  __syncwarp();

  if (rows == kTileRows && col0 + kTileCols <= m)
    warp_tile<kVec, true>(row_box[warp], row_area[warp], b, out, row0, rows,
                          col0, m, lane);
  else
    warp_tile<kVec, false>(row_box[warp], row_area[warp], b, out, row0, rows,
                           col0, m, lane);
}

}  // namespace

extern "C" {

// Launches the (N, M) IoU matrix on `stream`; returns the CUDA error code.
// `vec` != 0 selects the float4 store and needs m % 4 == 0 and a 16-byte
// aligned `out`.
int iou_matrix_launch(const void* a, const void* b, void* out, int n, int m,
                      int vec, void* stream) {
  const int col_tiles = (m + kTileCols - 1) / kTileCols;
  const long long tiles =
      static_cast<long long>((n + kTileRows - 1) / kTileRows) * col_tiles;
  const unsigned grid = static_cast<unsigned>((tiles + kWarps - 1) / kWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pa = static_cast<const float4*>(a);
  const auto pb = static_cast<const float4*>(b);
  const auto po = static_cast<float*>(out);
  if (vec)
    iou_matrix_kernel<true><<<grid, kWarps * 32, 0, s>>>(pa, pb, po, n, m,
                                                         col_tiles, tiles);
  else
    iou_matrix_kernel<false><<<grid, kWarps * 32, 0, s>>>(pa, pb, po, n, m,
                                                          col_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* iou_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
