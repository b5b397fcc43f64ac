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
// (V feature maps of 32x41x128 and their depths) are ~0.3 MB a view. A voxel
// accepts a view only within one voxel of the surface that view saw, so
// almost every (voxel, view) pair rejects: projecting each of them (265 M at
// 96 views) cost the previous design 6x its bound. This one rules out whole
// bricks of voxels per view first.
//
// Design: one launch, one block of 4 warps per brick of kBX x kBY x kBZ =
// 8 x 4 x 8 voxels (z fastest, the channel-last layout of the volume), one
// write.
//  1. Cull. Threads take the views, one a thread, kThreads at a time. For a
//     valid view a thread projects the brick's 8 corner voxels with the
//     predicate's own expressions and takes their camera-depth range [zlo,
//     zhi]. Only a depth d in the band [max(depth_min, zlo - voxel_size -
//     kEps), min(depth_max, zhi + voxel_size + kEps)] can accept a voxel of
//     the brick: an empty band culls the view (too near, behind the camera
//     or too far). No voxel nearer than depth_min - voxel_size can accept,
//     so the brick is cut at zcut = max(zlo, depth_min - voxel_size - kEps);
//     if zcut > kFootprintZ the pixels of the voxels beyond the cut lie in
//     the box of the rounded pixels of the cut brick's vertices (the
//     corners beyond the cut and the points where its 12 edges cross it),
//     widened by 1 and clamped to the image: an empty box culls the view.
//     The cut matters where the camera plane crosses the brick, which is
//     common, since the cameras stand inside the grid: most such bricks lie
//     to the side of the camera and their cut part outside the image.
//     Otherwise (zcut <= kFootprintZ) the box is the whole image. The
//     block then scans the boxes of all its views at once, their pixels end
//     to end, a pixel a thread in turn, for a depth in the band; none culls
//     the view. A corner that is not finite keeps it. The views kept
//     are compacted, in view order, into a shared-memory list of candidates
//     with their 12 matrix floats.
//  2. Why the margins are safe. In exact arithmetic a voxel's camera depth
//     is an affine function of its coordinates, so it lies between the
//     corners' (the corners are the brick's extreme voxels), and the image
//     of the cut brick, a convex polytope in front of the camera, is the
//     convex hull of its vertices' images. In float32 each camera
//     coordinate is off by at most a few ulps of the sum of its terms'
//     magnitudes (about 1e-5 m for grids of hundreds of voxels of
//     centimetres), far inside kEps = 1e-3 m, so a voxel that accepts lies
//     beyond the cut; at camera depths above kFootprintZ = 0.05 m such
//     errors move a pixel coordinate by fx * 1e-5 / 0.05, under 0.25 of a
//     pixel for focal lengths up to a thousand pixels, so the 1-pixel
//     widening holds every accepting voxel's rounded pixel.
//  3. A culled view is still a valid view: it rejects every voxel of the
//     brick, so it contributes 0, and the brick's "floor at 0" flag is set.
//  4. Fuse. A warp owns kSlices x-slices of kBY x kBZ voxels of the brick
//     and takes them in turn, 32 voxels, a lane each. Each lane runs its voxel through every candidate (kBatch
//     candidates' depths in flight at once), and a ballot per candidate
//     gives the voxels it accepts, kept in shared memory. Then the warp
//     walks its 32 voxel rows in order: a row no candidate accepts is 0 (a
//     valid view rejected it, or none was valid); for any other row the
//     lanes take the candidates, 32 at a time, those that accept it compute
//     its pixel once more with the same operations, and the whole warp reads
//     their feature rows in view order (C / 32 channels a lane, one
//     coalesced row each, kBatch rows in flight) and folds them into the
//     row's running max held in registers. The row is finished (floor at 0 where a valid view
//     rejected the voxel, -inf -> 0, zero_floor) and stored once, coalesced,
//     marked to be evicted first. No running max lives in shared
//     memory, so fp32 and bf16 fit as many blocks to an SM; shared memory
//     holds the candidate list (68 bytes a view) and the cull's state.

// The brick decomposition, the projection, step 1's cull and step 4's
// ballots live in fuse_views_common.cuh, which K3's backward K3b
// (fuse_views_bwd.cu) includes too: both decide accept and pixel alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fuse_views_common.cuh"

namespace {

using namespace fuse_views_common;

constexpr bool kCullViews = true;  // step 1 (the probe's "no cull" copy sets it false)

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

// one lane's part of an output row, marked to be evicted first (the volume
// is written once and read by a later kernel; the depth and feature maps are
// what the cache should keep)
template <typename T, int CPL>
__device__ __forceinline__ void store_row(Pack<T, CPL>* dst, const Pack<T, CPL>& r) {
  if constexpr (sizeof(r) == 16) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(&r));
  } else if constexpr (sizeof(r) == 8) {
    __stcs(reinterpret_cast<uint2*>(dst), *reinterpret_cast<const uint2*>(&r));
  } else if constexpr (sizeof(r) == 4) {
    __stcs(reinterpret_cast<unsigned*>(dst), *reinterpret_cast<const unsigned*>(&r));
  } else {
    *dst = r;
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
fuse_views_kernel(const T* __restrict__ feats, const float* __restrict__ depths, const float* __restrict__ mats,
                  const unsigned char* __restrict__ view_valid, int V, int X, int Y, int Z, Intrinsics k,
                  int zero_floor, T* __restrict__ out) {
  constexpr int C = 32 * CPL;
  extern __shared__ __align__(16) float s_mat[];  // candidate c's matrix float i at s_mat[i * V + c]
  int* s_view = reinterpret_cast<int*>(s_mat + 12 * V);  // candidate c's view
  // bit j of s_acc[w * V + c]: candidate c accepts voxel j of warp w's slice
  unsigned* s_acc = reinterpret_cast<unsigned*>(s_view + V);
  __shared__ CullScratch cs;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo[3], hi[3];
  brick_of(blockIdx.x, X, Y, Z, lo, hi);
  const int hw = k.H * k.W;

  // 1. cull: the views kept join the candidate list in view order
  bool culled;
  const int ncand = cull_brick<kCullViews>(depths, mats, view_valid, V, lo, hi, k, s_mat, s_view, cs, culled);

  // 4. fuse: this warp's x-slices of the brick in turn, a voxel a lane
  for (int x = lo[0] + warp; x <= hi[0]; x += kWarps) {
    // the lanes whose voxel some candidate accepts
    const unsigned touched = accept_ballots(depths, s_mat, s_view, V, ncand, x, lo, hi, k, s_acc + warp * V);
    __syncwarp();

    for (int j = 0; j < 32; ++j) {
      const int yj = lo[1] + j / kBZ, zj = lo[2] + j % kBZ;
      if (yj > hi[1] || zj > hi[2]) continue;  // uniform
      Pack<T, CPL> r;
      if (touched >> j & 1) {
        float acc[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = -INFINITY;
        int n_acc = 0;
        for (int c0 = 0; c0 < ncand; c0 += 32) {
          const int c = c0 + lane;
          const bool ok = c < ncand && (s_acc[warp * V + c] >> j & 1);
          const int pix = ok ? candidate_pixel(s_mat, V, c, x, yj, zj, k) : 0;  // its pixel once more
          unsigned acc_set = __ballot_sync(kFull, ok);
          n_acc += __popc(acc_set);
          while (acc_set) {  // uniform; lowest lane first, i.e. view order
            Pack<T, CPL> f[kBatch];  // up to kBatch rows read at once, folded in order
            int n = 0;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (acc_set) {
                const int l = __ffs(acc_set) - 1;
                acc_set &= acc_set - 1;
                const int pl = __shfl_sync(kFull, pix, l);
                f[u] = *reinterpret_cast<const Pack<T, CPL>*>(
                    feats + (static_cast<long long>(s_view[c0 + l]) * hw + pl) * C + lane * CPL);
                n = u + 1;
              }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (u < n) {
#pragma unroll
                for (int i = 0; i < CPL; ++i) acc[i] = nan_max(acc[i], to_float(f[u].v[i]));
              }
            }
          }
        }
        const bool rej = culled || n_acc < ncand;  // a valid view rejected this voxel
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          float val = acc[i];
          if (rej) val = nan_max(val, 0.0f);
          if (val == -INFINITY) val = 0.0f;
          if (zero_floor) val = nan_max(val, 0.0f);
          r.v[i] = from_float<T>(val);
        }
      } else {  // every valid view rejected this voxel, or none was valid: 0
#pragma unroll
        for (int i = 0; i < CPL; ++i) r.v[i] = from_float<T>(0.0f);
      }
      T* dst = out + ((static_cast<long long>(x) * Y + yj) * Z + zj) * C + lane * CPL;
      store_row(reinterpret_cast<Pack<T, CPL>*>(dst), r);
    }
    __syncwarp();  // the next slice rewrites s_acc
  }
}

// bytes of dynamic shared memory: the candidate list, 12 floats, an index
// and a word of accepted voxels for each warp, a view
long long smem_bytes(int V) { return static_cast<long long>(V) * (13 + kWarps) * 4; }

template <typename T, int CPL>
cudaError_t launch(const void* feats, const void* depths, const void* mats, const void* view_valid, int V, int X,
                   int Y, int Z, const Intrinsics& k, int zero_floor, void* out, void* stream) {
  const int smem = static_cast<int>(smem_bytes(V));
  cudaError_t err =
      cudaFuncSetAttribute(fuse_views_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long bricks = n_bricks(X, Y, Z);
  fuse_views_kernel<T, CPL><<<static_cast<unsigned>(bricks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const float*>(depths), static_cast<const float*>(mats),
      static_cast<const unsigned char*>(view_valid), V, X, Y, Z, k, zero_floor, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int C, const void* feats, const void* depths, const void* mats, const void* view_valid,
                         int V, int X, int Y, int Z, const Intrinsics& k, int zero_floor, void* out, void* stream) {
  switch (C) {
    case 32:
      return launch<T, 1>(feats, depths, mats, view_valid, V, X, Y, Z, k, zero_floor, out, stream);
    case 64:
      return launch<T, 2>(feats, depths, mats, view_valid, V, X, Y, Z, k, zero_floor, out, stream);
    case 128:
      return launch<T, 4>(feats, depths, mats, view_valid, V, X, Y, Z, k, zero_floor, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for V views; the wrapper
// checks it against the card's limit before launching.
extern "C" long long tpu3dsis_fuse_views_smem(int V) { return smem_bytes(V); }

// Kernel launches so far (one per call with a non-empty volume).
extern "C" long long tpu3dsis_fuse_views_launches() { return g_launches; }

// feats: (V, H, W, C) float32 or bf16; depths: (V, H, W) float32; mats:
// (V, 3, 4) float32 grid-to-camera rows; view_valid: (V,) uint8; out:
// (X, Y, Z, C) of feats' type; C = 32, 64 or 128; H, W < 32768. Returns the
// cudaError_t.
extern "C" int tpu3dsis_fuse_views(int is_bf16, const void* feats, const void* depths, const void* mats,
                                   const void* view_valid, int V, int H, int W, int C, int X, int Y, int Z, float fx,
                                   float fy, float cx, float cy, float depth_min, float depth_max, float voxel_size,
                                   int zero_floor, void* out, void* stream) {
  if (static_cast<long long>(X) * Y * Z == 0) return static_cast<int>(cudaSuccess);
  const Intrinsics k{fx, fy, cx, cy, depth_min, depth_max, voxel_size, H, W};
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(C, feats, depths, mats, view_valid, V, X, Y, Z, k, zero_floor, out, stream)
              : launch_width<float>(C, feats, depths, mats, view_valid, V, X, Y, Z, k, zero_floor, out, stream);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
