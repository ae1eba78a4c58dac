// Exact greedy class-aware NMS keep mask for Hopper (sm_90a), one
// thread-block cluster per image.
//
// Replaces heltondetection_tpu/ops/nms.py:nms_mask_fixpoint_pallas (the
// Pallas body _nms_fixpoint_kernel). Input: score-sorted boxes (B, N, 4) f32
// xyxy with the class offset already added; output: keep (B, N) as 0/1 bytes.
// Box j is suppressed iff some kept box i < j has
//     inter > thr * (area_i + area_j - inter + 1e-7)
// which is the Pallas predicate (not inter / union > thr).
//
// Design. The Pallas kernel holds the (N, N) suppression matrix S as f32 in
// VMEM (4 MB at N = 1024) and iterates K <- [K.S <= 0.5] on the MXU until it
// stops changing. Here S is a bitmask (N*N/8 bytes, 128 KB at N = 1024) that
// never leaves the chip: each image is a cluster of kCluster = 4 blocks on
// neighbouring SMs, and block (rank) c builds and keeps rows c, c + 4, ...
// in its own shared memory (32 KB at N = 1024). Interleaving the rows gives
// every block the same share of the triangle. In a block, warp w takes local
// rows w, w + 16, ...; each lane tests one column j of a 32-column word and
// __ballot_sync packs the word. Only words at or right of the diagonal are
// built, since row i suppresses only j > i. After a cluster barrier one warp
// of rank 0 runs nms::greedy_scan (nms_scan.cuh), reading every block's
// rows through distributed shared memory (cluster.map_shared_rank): the
// `removed` words stay in registers, each 32-row block's diagonal resolves
// in one lane, and the next unit's rows are loaded while the current one
// resolves. A second cluster barrier keeps every block resident until rank
// 0 has read its rows. The scan is exact whatever the depth of the
// suppression chain (the fixpoint needs one matvec per chain link, up to N).
//
// Limits. Each block holds all N boxes and areas and N/4 rows of N/32
// words: 20*N + N*N/32 bytes, so N <= 2400 in an H100's 227 KB. A cluster's
// four blocks must sit in one GPC: an H100 holds 30 such clusters at once
// (cudaOccupancyMaxActiveClusters), so B = 32 runs in two waves and B = 64
// in three.
//
// Bound on this card. Per image the work is N*(N-1)/2 pairwise tests of
// 14 f32 operations each, against 16*N bytes read and N written, so the
// operations bound it: about 0.11 us per image at N = 1024 at the card's
// 67 TFLOP/s f32 rate. That bound counts every operation at the FMA rate
// and ignores the scan. What bounds this kernel is the build's instruction
// throughput on four SMs per image (6 min/max, 7 add/mul, a compare, a ballot and the
// loads per pair, with 16 warps per SM for the scan warp's registers) and
// the scan, a chain of N dependent steps (3 dependent instructions per
// row in the diagonal, plus each unit's ORs and loads), which no number of
// SMs shortens: at N = 1024 about 29 us of build and 18 us of scan per wave
// on an H100.
//
// Rounding. Every operation of the predicate is written with an _rn
// intrinsic (and the build passes --fmad=false), so no multiply-add is
// contracted and the mask equals the plain PyTorch version's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;      // blocks per image
constexpr int kThreads = 512;    // per block; leaves the scan warp 128 regs
constexpr int kMaxSlots = 4;     // removed words per lane: N <= 4096
constexpr int kScanAhead = 1;    // units in flight: two would spill

size_t smem_bytes(int n) {
  const size_t words = static_cast<size_t>(n) / 32;
  const size_t rows = static_cast<size_t>(n) / kCluster;
  return static_cast<size_t>(n) * sizeof(float4)   // boxes
         + static_cast<size_t>(n) * sizeof(float)  // areas
         + rows * words * sizeof(uint32_t);        // this block's S rows
}

// Stages the image's boxes and areas in shared memory and builds this
// block's rows of S: rows i = rank, rank + kCluster, ... at local row
// i / kCluster. Returns the number of bits the calling warp set.
__device__ __forceinline__ unsigned build_rows(const float4* __restrict__ in,
                                               int n, float thr, int rank,
                                               unsigned char* smem) {
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + n);
  uint32_t* sup = reinterpret_cast<uint32_t*>(area + n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = in[i];
    box[i] = b;
    area[i] = nms::area_of(b);
  }
  __syncthreads();

  const int words = n >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned set = 0u;
  for (int q = warp; q < n / kCluster; q += nwarps) {
    const int i = q * kCluster + rank;
    const float4 bi = box[i];
    const float ai = area[i];
    uint32_t* srow = sup + static_cast<size_t>(q) * words;
    for (int w = i >> 5; w < words; ++w) {
      const int j = (w << 5) + lane;
      const bool s = j > i && nms::suppresses(bi, ai, box[j], area[j], thr);
      const uint32_t bits = __ballot_sync(nms::kFullMask, s);
      if (lane == 0) srow[w] = bits;
      set += __popc(bits);
    }
  }
  return set;
}

// The cluster's rows, read through distributed shared memory: row
// 32 * blk + k lives in rank k % kCluster at local row 32 * blk / kCluster +
// k / kCluster (32 is a multiple of kCluster, so the rank is known at
// compile time for every k).
struct ClusterRows {
  const uint32_t* rank_rows[kCluster];
  int words;
  __device__ __forceinline__ void load(int blk, int w,
                                       uint32_t (&buf)[32]) const {
    const size_t first = static_cast<size_t>(blk) * (32 / kCluster);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      buf[k] = rank_rows[k % kCluster][(first + k / kCluster) * words + w];
  }
};

// grid B * kCluster, clusters of kCluster blocks, block kThreads.
template <int WPL>
__global__ void __launch_bounds__(kThreads, 1)
nms_fixpoint_kernel(const float4* __restrict__ boxes,
                    uint8_t* __restrict__ keep, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kCluster;
  build_rows(boxes + static_cast<size_t>(img) * n, n, thr, rank, smem);
  cluster.sync();   // every block's rows are written and visible

  if (rank == 0 && threadIdx.x < 32) {
    uint32_t* sup = reinterpret_cast<uint32_t*>(
        smem + static_cast<size_t>(n) * (sizeof(float4) + sizeof(float)));
    ClusterRows rows;
#pragma unroll
    for (int c = 0; c < kCluster; ++c)
      rows.rank_rows[c] = cluster.map_shared_rank(sup, c);
    rows.words = n >> 5;
    uint32_t removed[WPL];
    nms::greedy_scan<WPL, kScanAhead>(rows, n >> 5, removed);
    nms::write_keep<WPL>(removed, n >> 5,
                         keep + static_cast<size_t>(img) * n);
  }
  cluster.sync();   // no block exits while rank 0 still reads its rows
}

// The build alone, with the full kernel's first barrier, for timing the
// build and the scan apart: adds the bits each image's S holds to bits[img].
__global__ void __launch_bounds__(kThreads, 1)
nms_fixpoint_build_kernel(const float4* __restrict__ boxes,
                          unsigned* __restrict__ bits, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kCluster;
  const unsigned set =
      build_rows(boxes + static_cast<size_t>(img) * n, n, thr, rank, smem);
  if ((threadIdx.x & 31) == 0 && set) atomicAdd(bits + img, set);
  cluster.sync();
}

cudaLaunchConfig_t cluster_config(int batch, int n, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(n);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The keep-mask kernel for n boxes, or nullptr if n needs more slots.
using KeepKernel = void (*)(const float4*, uint8_t*, int, float);
KeepKernel keep_kernel(int n) {
  const int slots = ((n >> 5) + 31) >> 5;
  switch (slots) {
    case 1: return nms_fixpoint_kernel<1>;
    case 2: return nms_fixpoint_kernel<2>;
    case 3: return nms_fixpoint_kernel<3>;
    case 4: return nms_fixpoint_kernel<kMaxSlots>;
    default: return nullptr;
  }
}

// cudaLaunchKernelEx's error, else the launch's own (which also clears it).
cudaError_t checked(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// Shared memory one block of the cluster needs for n boxes (n a multiple
// of 32).
long long nms_fixpoint_smem_bytes(int n) {
  return static_cast<long long>(smem_bytes(n));
}

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
long long nms_fixpoint_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Once per (device, n), before the first launch: opts every instance of the
// kernel in to the device's whole shared-memory limit and returns how many
// clusters of the n-box kernel the device can hold at once (0: it cannot
// run), or minus a CUDA error code.
int nms_fixpoint_prepare(int device, int n) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const KeepKernel keep_kernels[] = {
      nms_fixpoint_kernel<1>, nms_fixpoint_kernel<2>, nms_fixpoint_kernel<3>,
      nms_fixpoint_kernel<kMaxSlots>};
  for (const KeepKernel k : keep_kernels) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(nms_fixpoint_build_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const KeepKernel kernel = keep_kernel(n);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, n, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

// Launches one cluster per image on `stream`; returns the CUDA error code.
int nms_fixpoint_launch(const void* boxes, void* keep, int batch, int n,
                        float iou_thres, void* stream) {
  const KeepKernel kernel = keep_kernel(n);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(batch, n, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(checked(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float4*>(boxes),
      static_cast<uint8_t*>(keep), n, iou_thres)));
}

// Launches the build alone (bits: B zeroed uint32 counters); for timing.
int nms_fixpoint_build_launch(const void* boxes, void* bits, int batch,
                              int n, float iou_thres, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(batch, n, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(checked(cudaLaunchKernelEx(
      &cfg, nms_fixpoint_build_kernel, static_cast<const float4*>(boxes),
      static_cast<unsigned*>(bits), n, iou_thres)));
}

const char* nms_fixpoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
