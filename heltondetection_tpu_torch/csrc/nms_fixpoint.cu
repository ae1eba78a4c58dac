// Exact greedy class-aware NMS keep mask for Hopper (sm_90a).
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
// stops changing. A block here has at most 227 KB of shared memory, so S is
// a bitmask instead (N*N/8 = 128 KB at N = 1024), built once per image:
// warp w takes rows w, w + 32, ...; each lane tests one column j of a
// 32-column word and __ballot_sync packs the word. Only words at or right of
// the diagonal are built, since row i suppresses only j > i. Then one warp
// runs the greedy scan over the rows: removed |= S[i] for every row i that
// is not yet removed. The scan is exact whatever the depth of the
// suppression chain (the fixpoint needs one matvec per chain link, up to N).
//
// Bound on this card. Per image the work is N*(N-1)/2 pairwise tests of
// 14 f32 operations each, against 16*N bytes read and N written, so the
// operations bound it: about 0.11 us per image at N = 1024 at the card's
// 67 TFLOP/s f32 rate. One block per image leaves most of the 132 SMs idle
// at small B, and the scan is a chain of N dependent shared-memory steps;
// both are what a faster version would attack (rows split over several
// blocks, the removed words held in registers).
//
// Rounding. Every operation of the predicate is written with an _rn
// intrinsic (and the build passes --fmad=false), so no multiply-add is
// contracted and the mask equals the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

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

size_t smem_bytes(int n) {
  const size_t words = static_cast<size_t>(n) / 32;
  return static_cast<size_t>(n) * words * sizeof(uint32_t)  // S bitmask
         + static_cast<size_t>(n) * sizeof(float4)           // boxes
         + static_cast<size_t>(n) * sizeof(float)            // areas
         + words * sizeof(uint32_t);                         // removed
}

__global__ void __launch_bounds__(kThreads)
nms_fixpoint_kernel(const float4* __restrict__ boxes,
                    uint8_t* __restrict__ keep, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = n >> 5;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + n);
  uint32_t* removed = reinterpret_cast<uint32_t*>(area + n);
  uint32_t* sup = removed + words;  // row i at sup[i * words]

  const float4* in = boxes + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = in[i];
    box[i] = b;
    area[i] = area_of(b);
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n; i += nwarps) {
    const float4 bi = box[i];
    const float ai = area[i];
    uint32_t* srow = sup + static_cast<size_t>(i) * words;
    for (int w = i >> 5; w < words; ++w) {
      const int j = (w << 5) + lane;
      const bool s = j > i && suppresses(bi, ai, box[j], area[j], thr);
      const uint32_t bits = __ballot_sync(0xffffffffu, s);
      if (lane == 0) srow[w] = bits;
    }
  }
  __syncthreads();

  if (warp == 0) {
    for (int i = 0; i < n; ++i) {
      const int wi = i >> 5;
      const bool gone = (removed[wi] >> (i & 31)) & 1u;  // same in all lanes
      __syncwarp();
      if (gone) continue;
      const uint32_t* srow = sup + static_cast<size_t>(i) * words;
      for (int w = wi + lane; w < words; w += 32) removed[w] |= srow[w];
      __syncwarp();
    }
  }
  __syncthreads();

  uint8_t* out = keep + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = ((removed[i >> 5] >> (i & 31)) & 1u) ? 0 : 1;
}

}  // namespace

extern "C" {

// Shared memory one block needs for n boxes (n a multiple of 32).
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

// Launches one block per image on `stream`; returns the CUDA error code.
int nms_fixpoint_launch(const void* boxes, void* keep, int batch, int n,
                        float iou_thres, void* stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fixpoint_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<uint8_t*>(keep), n,
      iou_thres);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_fixpoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
