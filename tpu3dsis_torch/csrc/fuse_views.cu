// K3: multi-view back-projection with a running max (view fusion) for Hopper
// (sm_90a).
//
// Replaces tpu3dsis/geometry/projection.py::fuse_views (an XLA lax.scan over
// views: per view, project every voxel, gather the accepted feature rows into
// a full volume, max it into the carried volume). Same semantics
// (projection.py:452-504): a valid view contributes its feature where it
// accepts the voxel and 0 where it does not; the max starts at -inf, which
// becomes 0 where no view was valid; NaN propagates through the max; with
// zero_floor the result is floored at 0; invalid views are skipped whole.
// The acceptance predicate is the plain version's float32 arithmetic in its
// order (tpu3dsis_torch/geometry/projection.py::_project): built with
// --fmad=false and IEEE division, rintf rounds half to even as torch.round
// and jnp.round do, and a voxel whose camera depth is not positive and
// finite never accepts (nothing is read out of range for it).
//
// What bounds it on this card: bytes. The output volume is written once
// (240x48x240x128 in bf16 is 0.71 GB, ~0.21 ms at 3.35 TB/s); the inputs
// (V feature maps of 32x41x128 and their depths) are ~0.3 MB a view. The
// projections, ~20 float32 operations per voxel and view, take ~0.08 ms at
// 96 views at the float32 rate.
//
// Design: one launch, one pass, one write. A warp owns 32 consecutive voxels
// (z fastest, the channel-last layout of the JAX volume) and keeps their
// running max in shared memory, 32 rows of C values in the output's type (a
// max is exact in bf16). For each valid view, each lane projects its own
// voxel and reads the one depth it needs; a ballot names the lanes that
// accept, and for each of them the whole warp reads that voxel's feature row
// (C / 32 channels a lane, one coalesced row) and folds it into the row's
// max. A rejecting valid view only sets the lane's "floor at 0" flag. At the
// end each row is finished (flag, -inf -> 0, zero_floor) and stored once,
// coalesced. No per-view volume reaches device memory; feature rows are read
// only for accepted (voxel, view) pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;

long long g_launches = 0;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// max that propagates NaN from either side, as jnp.maximum and torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a >= b) ? a : b; }

// CPL consecutive channels of type T, one vector load or store
template <typename T, int CPL>
struct alignas(sizeof(T) * CPL) Pack {
  T v[CPL];
};

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
fuse_views_kernel(const T* __restrict__ feats, const float* __restrict__ depths, const float* __restrict__ mats,
                  const unsigned char* __restrict__ view_valid, int V, int H, int W, int X, int Y, int Z, float fx,
                  float fy, float cx, float cy, float depth_min, float depth_max, float voxel_size, int zero_floor,
                  T* __restrict__ out) {
  constexpr int C = 32 * CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  T* acc = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * 32 * C;  // this warp's 32 rows
  const long long n_vox = static_cast<long long>(X) * Y * Z;
  const long long n0 = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (n0 >= n_vox) return;  // the whole warp
  const long long n = n0 + lane;
  const bool live = n < n_vox;
  const float x = live ? static_cast<float>(n / (static_cast<long long>(Y) * Z)) : 0.0f;
  const float y = live ? static_cast<float>((n / Z) % Y) : 0.0f;
  const float z = live ? static_cast<float>(n % Z) : 0.0f;

  const T neg_inf = from_float<T>(-INFINITY);
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    Pack<T, CPL> p;
#pragma unroll
    for (int c = 0; c < CPL; ++c) p.v[c] = neg_inf;
    *reinterpret_cast<Pack<T, CPL>*>(acc + j * C + lane * CPL) = p;
  }

  bool rejected = false;  // some valid view rejected this lane's voxel
  const int hw = H * W;
  for (int v = 0; v < V; ++v) {
    if (!view_valid[v]) continue;  // uniform across the block
    const float* m = mats + v * 12;
    bool ok = false;
    int pix = 0;
    if (live) {
      const float cam_x = ((m[0] * x + m[1] * y) + m[2] * z) + m[3];
      const float cam_y = ((m[4] * x + m[5] * y) + m[6] * z) + m[7];
      const float zc = ((m[8] * x + m[9] * y) + m[10] * z) + m[11];
      if (zc > 0.0f && isfinite(zc)) {
        const float px = rintf(cam_x * fx / zc + cx);
        const float py = rintf(cam_y * fy / zc + cy);
        if (px >= 0.0f && px < static_cast<float>(W) && py >= 0.0f && py < static_cast<float>(H)) {
          pix = static_cast<int>(py) * W + static_cast<int>(px);
          const float d = __ldg(depths + static_cast<long long>(v) * hw + pix);
          ok = d >= depth_min && d <= depth_max && fabsf(d - zc) <= voxel_size;
        }
      }
    }
    rejected |= live && !ok;
    unsigned accepted = __ballot_sync(0xffffffffu, ok);
    const T* fv = feats + static_cast<long long>(v) * hw * C;
    while (accepted) {  // uniform: the same set in every lane
      const int j = __ffs(accepted) - 1;
      accepted &= accepted - 1;
      const int pj = __shfl_sync(0xffffffffu, pix, j);
      const Pack<T, CPL> f = *reinterpret_cast<const Pack<T, CPL>*>(fv + static_cast<long long>(pj) * C + lane * CPL);
      Pack<T, CPL>* a = reinterpret_cast<Pack<T, CPL>*>(acc + j * C + lane * CPL);
      Pack<T, CPL> cur = *a;
#pragma unroll
      for (int c = 0; c < CPL; ++c) cur.v[c] = from_float<T>(nan_max(to_float(cur.v[c]), to_float(f.v[c])));
      *a = cur;
    }
  }

  // each row: floor at 0 where a valid view rejected the voxel, -inf -> 0,
  // zero_floor; one coalesced store of the row
  for (int j = 0; j < 32; ++j) {
    const bool rej = __shfl_sync(0xffffffffu, rejected, j);
    if (n0 + j >= n_vox) break;
    Pack<T, CPL> r = *reinterpret_cast<const Pack<T, CPL>*>(acc + j * C + lane * CPL);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float val = to_float(r.v[c]);
      if (rej) val = nan_max(val, 0.0f);
      if (val == -INFINITY) val = 0.0f;
      if (zero_floor) val = nan_max(val, 0.0f);
      r.v[c] = from_float<T>(val);
    }
    *reinterpret_cast<Pack<T, CPL>*>(out + (n0 + j) * C + lane * CPL) = r;
  }
}

template <typename T, int CPL>
cudaError_t launch(const void* feats, const void* depths, const void* mats, const void* view_valid, int V, int H,
                   int W, int X, int Y, int Z, float fx, float fy, float cx, float cy, float depth_min,
                   float depth_max, float voxel_size, int zero_floor, void* out, void* stream) {
  const int smem = kWarps * 32 * 32 * CPL * static_cast<int>(sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(fuse_views_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_vox = static_cast<long long>(X) * Y * Z;
  const long long warps = (n_vox + 31) / 32;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  fuse_views_kernel<T, CPL><<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const float*>(depths), static_cast<const float*>(mats),
      static_cast<const unsigned char*>(view_valid), V, H, W, X, Y, Z, fx, fy, cx, cy, depth_min, depth_max,
      voxel_size, zero_floor, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int C, const void* feats, const void* depths, const void* mats, const void* view_valid,
                         int V, int H, int W, int X, int Y, int Z, float fx, float fy, float cx, float cy,
                         float depth_min, float depth_max, float voxel_size, int zero_floor, void* out,
                         void* stream) {
  switch (C) {
    case 32:
      return launch<T, 1>(feats, depths, mats, view_valid, V, H, W, X, Y, Z, fx, fy, cx, cy, depth_min, depth_max,
                          voxel_size, zero_floor, out, stream);
    case 64:
      return launch<T, 2>(feats, depths, mats, view_valid, V, H, W, X, Y, Z, fx, fy, cx, cy, depth_min, depth_max,
                          voxel_size, zero_floor, out, stream);
    case 128:
      return launch<T, 4>(feats, depths, mats, view_valid, V, H, W, X, Y, Z, fx, fy, cx, cy, depth_min, depth_max,
                          voxel_size, zero_floor, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for C channels; the wrapper
// checks it against the card's limit before launching.
extern "C" long long tpu3dsis_fuse_views_smem(int is_bf16, int C) {
  return static_cast<long long>(kWarps) * 32 * C * (is_bf16 ? 2 : 4);
}

// Kernel launches so far (one per call with a non-empty volume).
extern "C" long long tpu3dsis_fuse_views_launches() { return g_launches; }

// feats: (V, H, W, C) float32 or bf16; depths: (V, H, W) float32; mats:
// (V, 3, 4) float32 grid-to-camera rows; view_valid: (V,) uint8; out:
// (X, Y, Z, C) of feats' type; C = 32, 64 or 128. Returns the cudaError_t.
extern "C" int tpu3dsis_fuse_views(int is_bf16, const void* feats, const void* depths, const void* mats,
                                   const void* view_valid, int V, int H, int W, int C, int X, int Y, int Z, float fx,
                                   float fy, float cx, float cy, float depth_min, float depth_max, float voxel_size,
                                   int zero_floor, void* out, void* stream) {
  if (static_cast<long long>(X) * Y * Z == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(C, feats, depths, mats, view_valid, V, H, W, X, Y, Z, fx, fy, cx, cy,
                                            depth_min, depth_max, voxel_size, zero_floor, out, stream)
              : launch_width<float>(C, feats, depths, mats, view_valid, V, H, W, X, Y, Z, fx, fy, cx, cy, depth_min,
                                    depth_max, voxel_size, zero_floor, out, stream);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
