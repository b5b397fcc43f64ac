// K1: 3D RoI max-pool, forward, for Hopper (sm_90a).
//
// Replaces tpu3dsis/ops/roi_pool3d_pallas.py::roi_pool3d_pallas (and its XLA
// twin tpu3dsis/ops/roi_pool3d.py::roi_pool3d): every roi (scene voxels) is
// scaled by its level's 1/stride, floor(lo) / ceil(hi), its size clamped to at
// least 1, and cut into P^3 bins [floor(p*s/P), ceil((p+1)*s/P)) + lo clamped
// to the map. Each output is the max over its bin, or 0 for an empty bin. The
// bin arithmetic is float32, in the same operation order as _bin_bounds /
// _axis_bins, so the result is bit-exact against the plain version.
//
// What bounds it on this card: memory traffic and latency. The op does no
// arithmetic to speak of (one compare per voxel and channel); it reads each
// roi's voxels (about 1-8 times, as neighbouring bins share their edge voxel)
// and writes M*C*P^3 outputs. The TPU kernel pinned the level map in VMEM; a
// chunk's two level maps (2 x 32 x 24x12x24x128 values at batch 32) do not fit
// in shared memory, so here they stay in device memory and L2 serves the
// re-reads.
//
// Design (simple and correct first): one block per (roi, bin), threads over
// the channels, so neighbouring threads read neighbouring addresses of the
// channels-last map; each thread loops over its bin's voxels. The output is
// (M, C, P, P, P), the layout the classifier flattens, so a thread's store
// strides by P^3 elements. Making this fast (a block per roi staging its
// P^3 x C tile in shared memory, coalesced stores) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the bf16 inputs or 0
}

// Bin p of `pooled` along one axis, clamped to [0, extent].
__device__ __forceinline__ void bin_bounds(int p, int pooled, int lo, int hi,
                                           int extent, int* start, int* end) {
  const int size = max(hi - lo, 1);
  const float bin = static_cast<float>(size) / static_cast<float>(pooled);
  const int s = static_cast<int>(floorf(static_cast<float>(p) * bin)) + lo;
  const int e = static_cast<int>(ceilf(static_cast<float>(p + 1) * bin)) + lo;
  *start = min(max(s, 0), extent);
  *end = min(max(e, 0), extent);
}

template <typename T>
__global__ void roi_pool3d_kernel(const T* __restrict__ feats,
                                  const float* __restrict__ rois,
                                  const int* __restrict__ batch_idx,
                                  const int* __restrict__ level_idx,
                                  int num_levels, int batch, int W, int H,
                                  int L, int C, float s0, float s1, float s2,
                                  int P, T* __restrict__ out) {
  const int bins = P * P * P;
  const long long m = blockIdx.x / bins;
  const int bin = blockIdx.x % bins;
  const int px = bin / (P * P);
  const int py = (bin / P) % P;
  const int pz = bin % P;
  T* dst = out + m * C * bins + bin;

  const int lv = level_idx[m];
  const int b = batch_idx[m];
  if (lv < 0 || lv >= num_levels || b < 0 || b >= batch) {
    // an index the caller should never pass: make it visible, read nothing
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      dst[static_cast<long long>(c) * bins] = from_float<T>(nanf(""));
    }
    return;
  }
  const float scale = lv == 0 ? s0 : (lv == 1 ? s1 : s2);
  const float* roi = rois + m * 6;
  int sx, ex, sy, ey, sz, ez;
  bin_bounds(px, P, static_cast<int>(floorf(roi[0] * scale)),
             static_cast<int>(ceilf(roi[3] * scale)), W, &sx, &ex);
  bin_bounds(py, P, static_cast<int>(floorf(roi[1] * scale)),
             static_cast<int>(ceilf(roi[4] * scale)), H, &sy, &ey);
  bin_bounds(pz, P, static_cast<int>(floorf(roi[2] * scale)),
             static_cast<int>(ceilf(roi[5] * scale)), L, &sz, &ez);
  const bool empty = ex <= sx || ey <= sy || ez <= sz;

  const T* src =
      feats + (static_cast<long long>(lv) * batch + b) * W * H * L * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = -INFINITY;
    if (!empty) {
      for (int x = sx; x < ex; ++x) {
        for (int y = sy; y < ey; ++y) {
          const T* row = src + (static_cast<long long>(x) * H + y) * L * C + c;
          for (int z = sz; z < ez; ++z) {
            v = fmaxf(v, to_float(row[static_cast<long long>(z) * C]));
          }
        }
      }
    }
    dst[static_cast<long long>(c) * bins] = from_float<T>(empty ? 0.0f : v);
  }
}

}  // namespace

// feats: (num_levels, batch, W, H, L, C) contiguous, float32 or bfloat16;
// rois: (M, 6) float32; batch_idx, level_idx: (M,) int32 (level 0-based);
// s0..s2: spatial scale of each level; out: (M, C, P, P, P), feats' type.
// Returns the cudaError_t of the launch.
extern "C" int tpu3dsis_roi_pool3d(const void* feats, int is_bf16,
                                   int num_levels, int batch, int W, int H,
                                   int L, int C, const void* rois,
                                   const void* batch_idx,
                                   const void* level_idx, int M, float s0,
                                   float s1, float s2, int P, void* out,
                                   void* stream) {
  if (M == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(M) * P * P * P);
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_pool3d_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<const float*>(rois), static_cast<const int*>(batch_idx),
        static_cast<const int*>(level_idx), num_levels, batch, W, H, L, C, s0,
        s1, s2, P, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_pool3d_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(rois),
        static_cast<const int*>(batch_idx),
        static_cast<const int*>(level_idx), num_levels, batch, W, H, L, C, s0,
        s1, s2, P, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
