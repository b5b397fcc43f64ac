// K3b: the backward of K3 (multi-view back-projection with a running max)
// for Hopper (sm_90a).
//
// Replaces the gradient of tpu3dsis/geometry/projection.py::fuse_views that
// the JAX package takes when the ENet trains (FIX_ENET False): its custom VJP
// _onehot_row_gather_bwd (projection.py:173-213, a scatter-add of voxel
// cotangents into pixel rows) under autodiff of the view scan's running max
// (:452-454) and of the -inf -> 0 fill (:499). One sample, float32, with
// view_valid and without zero_floor.
//
// Semantics, per voxel p and channel c: walk the valid views in order; x_v
// is the view's feature at its accepted pixel, or 0 where the view does not
// accept the voxel (a view K3's cull drops for the voxel's brick included);
// m is the final max and t the number of views with x_v == m. The scan's
// max splits a tie 0.5 / 0.5 at each step (jnp.maximum, torch.maximum), so
// the cotangent g[p, c] reaches the first of those views (the one that
// raised the carry to m) with weight 0.5^(t-1) and the j-th, j >= 2, with
// 0.5^(t-j+1) (for t = 3: 0.25, 0.25, 0.5). A share is added to
// dF[v, pix, c] only where view v accepted the voxel; one that lands on a
// non-accepting view's 0 is lost. A voxel that no valid view accepts sends
// nothing (every x_v is a constant 0, or no view was valid and the fill
// took the -inf). Invalid views take no part. A NaN feature is not
// differentiated (no x_v equals a NaN m).
//
// What bounds it on this card: bytes. The cotangent rows of the voxels that
// some view accepts are read once (a view accepts a voxel only within one
// voxel of the surface it saw, so these are a few percent of the volume),
// the feature and depth maps (a few MB, held in L2 and read twice), and the
// (V, H, W, C) float32 gradient is zeroed by the wrapper and added to.
//
// Design: one launch, one block of 4 warps per K3 brick of 8 x 4 x 8 voxels.
//  1. The brick's candidate views and, per x-slice of 32 voxels, the
//     candidates that accept each voxel: fuse_views_common.cuh's cull and
//     ballots, K3's own code, so accept and pixel are decided as K3 decided
//     them. The fused max is recomputed, not saved.
//  2. A warp walks the accepted voxels of its slice in turn, C / 32 channels
//     a lane. First walk, over the voxel's accepting candidates in view
//     order (each lane of the warp computes one candidate's pixel once more,
//     then the warp reads the candidates' feature rows, kBatch in flight):
//     the largest feature and how many candidates attain it. The valid views
//     that do not accept the voxel (culled or rejecting, n_valid - n_acc of
//     them) each give a 0: with them the fused value m and the tie count t.
//  3. Second walk, in the same order: a candidate whose feature equals m
//     takes its staged share. Its place among the tied views counts the
//     tied candidates before it and, where m == 0, the valid views before it
//     that do not accept the voxel: valid_rank[v] (the valid views before
//     view v) less the accepting candidates before it. The share g * 2^-e is
//     exact; it goes to the gradient by a float32 atomicAdd, so a pixel's sum
//     is taken in an order that can change from launch to launch.

#include <cuda_runtime.h>
#include <math.h>

#include "fuse_views_common.cuh"

namespace {

using namespace fuse_views_common;

constexpr bool kCullViews = true;  // the cull (the probe's "no cull" copy sets it false)
constexpr bool kScatter = true;    // the second walk (the probe's "first walk only" copy sets it false)

long long g_launches = 0;

// CPL consecutive float channels, one vector load
template <int CPL>
struct alignas(4 * CPL) Row {
  float v[CPL];
};

template <int CPL>
__global__ void __launch_bounds__(kThreads)
fuse_views_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ feats,
                      const float* __restrict__ depths, const float* __restrict__ mats,
                      const unsigned char* __restrict__ view_valid, const int* __restrict__ valid_rank, int V, int X,
                      int Y, int Z, Intrinsics k, float* __restrict__ dfeats) {
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
  const int n_valid = __ldg(valid_rank + V);

  // 1. the candidates, in view order
  bool culled;
  const int ncand = cull_brick<kCullViews>(depths, mats, view_valid, V, lo, hi, k, s_mat, s_view, cs, culled);

  for (int x = lo[0] + warp; x <= hi[0]; x += kWarps) {
    unsigned todo = accept_ballots(depths, s_mat, s_view, V, ncand, x, lo, hi, k, s_acc + warp * V);
    __syncwarp();
    while (todo) {  // uniform: the slice's voxels that some candidate accepts, in turn
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int yj = lo[1] + j / kBZ, zj = lo[2] + j % kBZ;
      const Row<CPL> g =
          *reinterpret_cast<const Row<CPL>*>(grad + ((static_cast<long long>(x) * Y + yj) * Z + zj) * C + lane * CPL);

      // 2. first walk: the largest accepted feature and how many attain it
      float mx[CPL];
      int cnt[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        mx[i] = -INFINITY;
        cnt[i] = 0;
      }
      int n_acc = 0;
      for (int c0 = 0; c0 < ncand; c0 += 32) {
        const int c = c0 + lane;
        const bool ok = c < ncand && (s_acc[warp * V + c] >> j & 1);
        const int pix = ok ? candidate_pixel(s_mat, V, c, x, yj, zj, k) : 0;
        unsigned acc_set = __ballot_sync(kFull, ok);
        n_acc += __popc(acc_set);
        while (acc_set) {  // uniform; lowest lane first, i.e. view order
          Row<CPL> f[kBatch];
          int n = 0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (acc_set) {
              const int l = __ffs(acc_set) - 1;
              acc_set &= acc_set - 1;
              const int pl = __shfl_sync(kFull, pix, l);
              f[u] = *reinterpret_cast<const Row<CPL>*>(
                  feats + (static_cast<long long>(s_view[c0 + l]) * hw + pl) * C + lane * CPL);
              n = u + 1;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < n) {
#pragma unroll
              for (int i = 0; i < CPL; ++i) {
                const float fv = f[u].v[i];
                if (fv > mx[i]) {
                  mx[i] = fv;
                  cnt[i] = 1;
                } else if (fv == mx[i]) {
                  ++cnt[i];
                }
              }
            }
          }
        }
      }
      // the fused value and its ties: each valid view that does not accept
      // the voxel gives a 0
      const int n_zero = n_valid - n_acc;
      float m[CPL];
      int t[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        m[i] = mx[i];
        t[i] = cnt[i];
        if (n_zero > 0 && mx[i] < 0.0f) {
          m[i] = 0.0f;
          t[i] = n_zero;
        } else if (n_zero > 0 && mx[i] == 0.0f) {
          t[i] += n_zero;
        }
      }
      if (!kScatter) {  // keep the first walk's result live, so it is not compiled away
        if (t[0] < 0) dfeats[0] = m[0];
        continue;
      }

      // 3. second walk: the staged shares of the candidates that attain m
      int tied[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) tied[i] = 0;
      int acc_before = 0;
      for (int c0 = 0; c0 < ncand; c0 += 32) {
        const int c = c0 + lane;
        const bool ok = c < ncand && (s_acc[warp * V + c] >> j & 1);
        const int pix = ok ? candidate_pixel(s_mat, V, c, x, yj, zj, k) : 0;
        unsigned acc_set = __ballot_sync(kFull, ok);
        while (acc_set) {
          Row<CPL> f[kBatch];
          int vw[kBatch], pw[kBatch];
          int n = 0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (acc_set) {
              const int l = __ffs(acc_set) - 1;
              acc_set &= acc_set - 1;
              pw[u] = __shfl_sync(kFull, pix, l);
              vw[u] = s_view[c0 + l];
              f[u] = *reinterpret_cast<const Row<CPL>*>(feats + (static_cast<long long>(vw[u]) * hw + pw[u]) * C +
                                                        lane * CPL);
              n = u + 1;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < n) {
              // the valid views before this one that give the voxel a 0
              const int zeros_before = __ldg(valid_rank + vw[u]) - acc_before;
              float* dst = dfeats + (static_cast<long long>(vw[u]) * hw + pw[u]) * C + lane * CPL;
#pragma unroll
              for (int i = 0; i < CPL; ++i) {
                if (f[u].v[i] == m[i]) {
                  const int place = 1 + tied[i] + (m[i] == 0.0f ? zeros_before : 0);
                  const int e = place == 1 ? t[i] - 1 : t[i] - place + 1;
                  atomicAdd(dst + i, ldexpf(g.v[i], -e));
                  ++tied[i];
                }
              }
              ++acc_before;
            }
          }
        }
      }
    }
    __syncwarp();  // the next slice rewrites s_acc
  }
}

// bytes of dynamic shared memory: the candidate list, 12 floats, an index
// and a word of accepted voxels for each warp, a view (K3's)
long long smem_bytes(int V) { return static_cast<long long>(V) * (13 + kWarps) * 4; }

template <int CPL>
cudaError_t launch(const void* grad, const void* feats, const void* depths, const void* mats, const void* view_valid,
                   const void* valid_rank, int V, int X, int Y, int Z, const Intrinsics& k, void* dfeats,
                   void* stream) {
  const int smem = static_cast<int>(smem_bytes(V));
  cudaError_t err =
      cudaFuncSetAttribute(fuse_views_bwd_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fuse_views_bwd_kernel<CPL><<<static_cast<unsigned>(n_bricks(X, Y, Z)), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const float*>(feats), static_cast<const float*>(depths),
      static_cast<const float*>(mats), static_cast<const unsigned char*>(view_valid),
      static_cast<const int*>(valid_rank), V, X, Y, Z, k, static_cast<float*>(dfeats));
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for V views; the wrapper
// checks it against the card's limit before launching.
extern "C" long long tpu3dsis_fuse_views_bwd_smem(int V) { return smem_bytes(V); }

// Kernel launches so far (one per call with a non-empty volume).
extern "C" long long tpu3dsis_fuse_views_bwd_launches() { return g_launches; }

// grad: (X, Y, Z, C) float32 cotangent of K3's output; feats: (V, H, W, C)
// float32; depths: (V, H, W) float32; mats: (V, 3, 4) float32 grid-to-camera
// rows; view_valid: (V,) uint8; valid_rank: (V + 1,) int32, the valid views
// before each view and their total last; dfeats: (V, H, W, C) float32,
// zeroed, added to. C = 32, 64 or 128; H, W < 32768. Returns the
// cudaError_t.
extern "C" int tpu3dsis_fuse_views_bwd(const void* grad, const void* feats, const void* depths, const void* mats,
                                       const void* view_valid, const void* valid_rank, int V, int H, int W, int C,
                                       int X, int Y, int Z, float fx, float fy, float cx, float cy, float depth_min,
                                       float depth_max, float voxel_size, void* dfeats, void* stream) {
  if (static_cast<long long>(X) * Y * Z == 0) return static_cast<int>(cudaSuccess);
  const Intrinsics k{fx, fy, cx, cy, depth_min, depth_max, voxel_size, H, W};
  cudaError_t err;
  switch (C) {
    case 32:
      err = launch<1>(grad, feats, depths, mats, view_valid, valid_rank, V, X, Y, Z, k, dfeats, stream);
      break;
    case 64:
      err = launch<2>(grad, feats, depths, mats, view_valid, valid_rank, V, X, Y, Z, k, dfeats, stream);
      break;
    case 128:
      err = launch<4>(grad, feats, depths, mats, view_valid, valid_rank, V, X, Y, Z, k, dfeats, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
