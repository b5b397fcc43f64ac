// K3b: the backward of K3 (multi-view back-projection with a running max)
// for Hopper (sm_90a), for a batch of samples in one call.
//
// Replaces the gradient of tpu3dsis/geometry/projection.py::fuse_views that
// the JAX package takes when the ENet trains (FIX_ENET False): its custom VJP
// _onehot_row_gather_bwd (projection.py:173-213, a scatter-add of voxel
// cotangents into pixel rows) under autodiff of the view scan's running max
// (:452-454) and of the -inf -> 0 fill (:499). Float32, with view_valid and
// without zero_floor; each sample's views fuse into its own volume.
//
// Semantics, per sample, voxel p and channel c: walk the valid views in
// order; x_v is the view's feature at its accepted pixel, or 0 where the
// view does not accept the voxel; m is the final max and t the number of
// views with x_v == m. The scan's max splits a tie 0.5 / 0.5 at each step
// (jnp.maximum, torch.maximum), so the cotangent g[p, c] reaches the first
// of those views (the one that raised the carry to m) with weight 0.5^(t-1)
// and the j-th, j >= 2, with 0.5^(t-j+1) (for t = 3: 0.25, 0.25, 0.5). A
// share is added to dF[v, pix, c] only where view v accepted the voxel; one
// that lands on a non-accepting view's 0 is lost. A voxel that no valid
// view accepts sends nothing (every x_v is a constant 0, or no view was
// valid and the fill took the -inf). Invalid views take no part. A NaN
// feature is not differentiated (no x_v equals a NaN m). Accept and pixel
// are decided by K3's own code (fuse_views_common.cuh: project,
// depth_accepts), so this differentiates K3's choices; K3's per-brick cull
// only skips views that reject, so it changes no value.
//
// What bounds it on this card: bytes. The cotangent rows of the voxels that
// some view accepts are read once (a view accepts a voxel only within one
// voxel of the surface it saw, so these are a few percent of the volume or
// less), the feature rows they take once, the depths, and the (B, V, H, W,
// C) float32 gradient is written once (zeroed, then added to).
//
// What held the per-sample design (a block per K3 brick, a warp walking the
// accepted voxels of its slices one at a time, twice) was its longest chain:
// the accepted voxels sit on surfaces, so a few bricks hold most of them and
// their warps ran tens of voxels x 2 walks of dependent loads while the rest
// of the card idled. And finding the accepted voxels by projecting every
// voxel into every view is itself the larger part of the work where the
// depth maps are noisy and the cull keeps every view (the training step's
// random depths: 8.8 M projections for 12,772 accepted voxels). So:
//  1. Pass 1 zeroes the gradient (float4 stores spread over its blocks) and
//     lists the accepted voxels from the pixels' side: a voxel can accept a
//     view only at the pixel it projects to, within voxel_size of that
//     pixel's depth, so 8 lanes per (sample, view, pixel) run the predicate
//     on just the voxels of that pixel's slab (a few dozen) and keep those
//     that accept there. A bitmap over the batch's voxels makes each listed
//     once (sample * X*Y*Z + voxel, int32, one atomic a warp).
//  2. Pass 2, launched as pass 1's programmatic dependent: a grid that fills
//     the card once walks the list, its length read on the card, a voxel to
//     a group of C / 4 lanes (float4 channels a lane; 1, 2 or 4 voxels a
//     warp). The group decides the predicate of each valid view for its
//     voxel, a view a lane, and keeps the accepting views' rows and their
//     zeros-before in shared memory, in view order. It loads those rows
//     kRows at a time, all in flight, into registers, and forms the max and
//     its count per channel; the valid views that do not accept the voxel
//     each give a 0, which sets m and t. Then each view whose value equals m
//     takes its staged share g * 2^-e (exact), its place counting the tied
//     views before it and, where m == 0, the valid views before it that do
//     not accept the voxel (valid_rank[v] less the accepting views before
//     it). Rows still in registers are not read again; of the earlier rounds
//     (more than kRows accepting views) only the rows that met or raised the
//     running max are reloaded. A lane adds its 4 channels' shares to the
//     gradient by one float4 atomicAdd (0 where a channel does not tie: x +
//     0 is x, and the gradient holds no -0), so a pixel's sum is taken in
//     an order that can change from launch to launch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include <algorithm>

#include "fuse_views_common.cuh"

namespace {

using namespace fuse_views_common;

constexpr bool kPass1 = true;      // the probe's "pass 2 only" copy reuses the list of the call before
constexpr bool kPass2 = true;      // the probe's "pass 1 only" copy stops after the list
constexpr bool kZeroOnly = false;  // the probe's "zero fill alone" copy
constexpr int kListThreads = 256;  // pass 1's block
constexpr int kSlabLanes = 8;      // pass 1's lanes a pixel: a corner of its slab each, then its voxels in turn
static_assert(kSlabLanes % 8 == 0 && 32 % kSlabLanes == 0, "a slab's 8 corners to a pixel's lanes");
constexpr int kGradThreads = 128;  // pass 2's block
constexpr int kRows = 4;           // feature rows a lane holds in registers
// pass 1's margins for float error, in FLT_EPSILON (2u, u = 2^-24) of the
// magnitudes each error scales with (see k3b_list_pass): about 4 times the
// bound of the inverse's error, 20 and 30 times those of the pixel's and
// the camera coordinates'
constexpr float kUlps = 64.0f;

long long g_launches = 0;

// Pass 1: kSlabLanes lanes per (sample, view, pixel). A voxel accepts the
// view at pixel p only if its rounded projection is p and its camera depth
// lies within voxel_size of p's depth d. So the camera coordinates that the
// predicate computes for it lie in p's slab: the frustum of p's square
// between camera depths z0 = max(d - voxel_size - kEps, 0) and z1 = d +
// voxel_size + kEps, its square widened by the pixel's rounding error (the
// division and the sum of project(): at most 3u (|q| + |q + c|), q + c in
// the image, so 6u (max(W, H) + max(|cx|, |cy|)) pixels). Its exact camera
// coordinates are off from those by cam_row's error: three products and
// three sums, at most 4u of the row's summed magnitudes, which over the grid
// are at most the view's extent, the largest row of |m_r0| (X - 1) + |m_r1|
// (Y - 1) + |m_r2| (Z - 1) + |m_r3|. Each lane maps a corner of the slab to
// the grid through the inverse of the view's 3x3, R (the adjugate over the
// determinant), and widens it on each axis r by that error through R^-1
// (cam_err * sum_j |R^-1_rj|) and by the inverse's own error (the corner's
// arithmetic, the adjugate, the determinant and the product: at most about
// 33u of max |R^-1| times the sum of the corner's and the translation's
// magnitudes, for R a rotation times a uniform scale, as every view matrix
// of a rigid pose and a grid of cubic voxels is; for any other R the
// adjugate's and the determinant's cancellations grow it by at most the
// square of R's condition number, the view's margin[] factor, which the
// host computes with the matrices). Each margin is kUlps FLT_EPSILON (128u)
// of its magnitude, so it grows with the grid, the image and the
// coordinates. The box of the 8 widened corners comes from
// shuffles. The lanes then run the predicate's own code on the box's voxels
// in turn; the voxels that accept at p are marked in a bitmap, and those
// marked first are appended to the list, one atomic a warp. Every voxel
// some valid view accepts is listed once; no others.
__global__ void __launch_bounds__(kListThreads)
k3b_list_pass(const float* __restrict__ depths, const float* __restrict__ mats, const float* __restrict__ margin,
              const unsigned char* __restrict__ view_valid, int B, int V, int X, int Y, int Z, Intrinsics k,
              float4* __restrict__ dfeats, long long n4, int* __restrict__ list, int* __restrict__ scratch) {
  asm volatile("griddepcontrol.launch_dependents;");  // pass 2 may start: it waits where it reads the list
  for (long long i = static_cast<long long>(blockIdx.x) * kListThreads + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kListThreads) {
    dfeats[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (kZeroOnly) return;
  const int lane = threadIdx.x & 31, part = lane % kSlabLanes, hw = k.H * k.W;
  const long long pixel = (static_cast<long long>(blockIdx.x) * kListThreads + threadIdx.x) / kSlabLanes;
  // no lane leaves early: the whole warp takes part in the shuffles and ballots
  bool live = pixel < static_cast<long long>(B) * V * hw;
  const int bv = live ? static_cast<int>(pixel / hw) : 0, p0 = live ? static_cast<int>(pixel % hw) : 0;
  const float d0 = live ? __ldg(depths + pixel) : 0.0f;
  live = live && __ldg(view_valid + bv) && d0 >= k.depth_min && d0 <= k.depth_max;
  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = live ? __ldg(mats + bv * 12 + i) : 0.0f;
  float extent = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    extent = fmaxf(extent, fabsf(m[4 * r]) * (X - 1) + fabsf(m[4 * r + 1]) * (Y - 1) +
                               fabsf(m[4 * r + 2]) * (Z - 1) + fabsf(m[4 * r + 3]));
  }
  const float cam_err = kUlps * FLT_EPSILON * extent;
  const float slack = kUlps * FLT_EPSILON * (fmaxf(k.W, k.H) + fmaxf(fabsf(k.cx), fabsf(k.cy)));
  // camera to grid: g = R^-1 (c - t), R and t the matrix's 3x3 and last column
  const float a[3][3] = {{m[5] * m[10] - m[6] * m[9], m[2] * m[9] - m[1] * m[10], m[1] * m[6] - m[2] * m[5]},
                         {m[6] * m[8] - m[4] * m[10], m[0] * m[10] - m[2] * m[8], m[2] * m[4] - m[0] * m[6]},
                         {m[4] * m[9] - m[5] * m[8], m[1] * m[8] - m[0] * m[9], m[0] * m[5] - m[1] * m[4]}};
  const float rdet = 1.0f / (m[0] * a[0][0] + m[1] * a[1][0] + m[2] * a[2][0]);
  const float z0 = fmaxf((d0 - k.voxel_size) - kEps, 0.0f), z1 = (d0 + k.voxel_size) + kEps;
  const float u = (p0 % k.W) + (part & 1 ? 0.5f + slack : -0.5f - slack);
  const float v = (p0 / k.W) + (part & 2 ? 0.5f + slack : -0.5f - slack);
  const float zc = part & 4 ? z1 : z0;
  const float e[3] = {(u - k.cx) * (1.0f / k.fx) * zc, (v - k.cy) * (1.0f / k.fy) * zc, zc};
  const float c[3] = {e[0] - m[3], e[1] - m[7], e[2] - m[11]};
  const float size = (fabsf(e[0]) + fabsf(m[3])) + (fabsf(e[1]) + fabsf(m[7])) + (fabsf(e[2]) + fabsf(m[11]));
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) amax = fmaxf(amax, fmaxf(fabsf(a[r][0]), fmaxf(fabsf(a[r][1]), fabsf(a[r][2]))));
  const float inv_err = kUlps * FLT_EPSILON * size * amax * fabsf(rdet) * (live ? __ldg(margin + bv) : 1.0f);
  float lo[3], hi[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float g = (a[r][0] * c[0] + a[r][1] * c[1] + a[r][2] * c[2]) * rdet;
    const float w = cam_err * ((fabsf(a[r][0]) + fabsf(a[r][1])) + fabsf(a[r][2])) * fabsf(rdet) + inv_err;
    lo[r] = g - w;
    hi[r] = g + w;
    if (!(isfinite(lo[r]) && isfinite(hi[r]))) {  // a singular matrix: the whole grid (fminf would drop a NaN)
      lo[r] = -INFINITY;
      hi[r] = INFINITY;
    }
  }
#pragma unroll
  for (int o = 1; o < kSlabLanes; o <<= 1) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      lo[r] = fminf(lo[r], __shfl_xor_sync(kFull, lo[r], o));
      hi[r] = fmaxf(hi[r], __shfl_xor_sync(kFull, hi[r], o));
    }
  }
  // the box's voxels, clamped to the grid
  const int dims[3] = {X, Y, Z};
  int first[3], n[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float l = isfinite(lo[r]) ? fmaxf(ceilf(lo[r]), 0.0f) : 0.0f;
    const float h = isfinite(hi[r]) ? fminf(floorf(hi[r]), dims[r] - 1.0f) : dims[r] - 1.0f;
    first[r] = static_cast<int>(l);
    n[r] = h >= l ? static_cast<int>(h) - first[r] + 1 : 0;
  }
  const int total = live ? n[0] * n[1] * n[2] : 0, xyz = X * Y * Z, b = bv / V;
  unsigned* marked = reinterpret_cast<unsigned*>(scratch + 1);
  const int rounds = static_cast<int>(__reduce_max_sync(kFull, (total + kSlabLanes - 1) / kSlabLanes));
  for (int j = part; j < rounds * kSlabLanes; j += kSlabLanes) {  // uniform across the warp
    bool fresh = false;
    int vox = 0;
    if (j < total) {
      const int z = first[2] + j % n[2], y = first[1] + (j / n[2]) % n[1], x = first[0] + j / (n[2] * n[1]);
      int pix;
      float zv;
      if (project(m, static_cast<float>(x), static_cast<float>(y), static_cast<float>(z), k, pix, zv) &&
          pix == p0 && depth_accepts(d0, zv, k)) {
        vox = b * xyz + (x * Y + y) * Z + z;
        const unsigned bit = 1u << (vox & 31);
        fresh = !(atomicOr(marked + (vox >> 5), bit) & bit);
      }
    }
    const unsigned set = __ballot_sync(kFull, fresh);
    if (set) {
      int base = 0;
      if (lane == 0) base = atomicAdd(scratch, __popc(set));
      base = __shfl_sync(kFull, base, 0);
      if (fresh) list[base + __popc(set & ((1u << lane) - 1))] = vox;
    }
  }
}

// Pass 2: G lanes a voxel, 4 channels a lane (C = 4 G).
template <int G>
__global__ void __launch_bounds__(kGradThreads)
k3b_grad_pass(const float* __restrict__ grad, const float* __restrict__ feats, const float* __restrict__ depths,
              const float* __restrict__ mats, const unsigned char* __restrict__ view_valid,
              const int* __restrict__ valid_rank, int V, int X, int Y, int Z, Intrinsics k, const int* list,
              const int* count, float* __restrict__ dfeats) {
  constexpr int C = 4 * G, kGroups = kGradThreads / G;
  // per group, the accepting views in view order: {v * H * W + pixel, the
  // valid views before v that do not accept the voxel}
  extern __shared__ int2 s_views[];
  const int lane = threadIdx.x & 31, sub = lane % G, group = threadIdx.x / G;
  const int lead = lane - sub;  // the group's first lane
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1) << lead;
  int2* acc = s_views + group * V;
  const int hw = k.H * k.W;
  const int xyz = X * Y * Z;

  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 1's list, count and zeroed gradient
  const int n = *count;
  for (int i = blockIdx.x * kGroups + group; i < n; i += gridDim.x * kGroups) {
    const int e = list[i];  // sample * X*Y*Z + voxel, under 2^31
    // its cotangent row, in flight while the views are decided
    const float4 g = __ldg(reinterpret_cast<const float4*>(grad + static_cast<long long>(e) * C + sub * 4));
    const int b = e / xyz, vox = e - b * xyz;
    const int z = vox % Z, y = (vox / Z) % Y, x = vox / Z / Y;
    const float* mb = mats + static_cast<long long>(b) * V * 12;
    const float* db = depths + static_cast<long long>(b) * V * hw;
    const unsigned char* vb = view_valid + static_cast<long long>(b) * V;
    const int* rb = valid_rank + static_cast<long long>(b) * (V + 1);

    // 1. the views that accept the voxel, a view a lane, G at a time
    int n_acc = 0;
    for (int c0 = 0; c0 < V; c0 += G) {
      const int v = c0 + sub;
      bool ok = false;
      int pix = 0;
      if (v < V && __ldg(vb + v)) {
        float m[12], zc;
#pragma unroll
        for (int j = 0; j < 12; ++j) m[j] = __ldg(mb + v * 12 + j);
        if (project(m, static_cast<float>(x), static_cast<float>(y), static_cast<float>(z), k, pix, zc)) {
          ok = depth_accepts(__ldg(db + static_cast<long long>(v) * hw + pix), zc, k);
        }
      }
      const unsigned bits = __ballot_sync(gmask, ok) >> lead;
      if (ok) {
        const int at = n_acc + __popc(bits & ((1u << sub) - 1));
        acc[at] = make_int2(v * hw + pix, __ldg(rb + v) - at);
      }
      n_acc += __popc(bits);
    }
    __syncwarp(gmask);

    // 2. their rows, kRows in flight: the largest value and how many attain it
    const float* fb = feats + static_cast<long long>(b) * V * hw * C + sub * 4;
    float4 row[kRows];
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    int cnt[4] = {0, 0, 0, 0};
    unsigned long long met = 0;  // bit j (j < 64): the j-th accepting view's row met or raised the running max
    int held = 0;                // the first row still in registers
    for (int j0 = 0; j0 < n_acc; j0 += kRows) {
      held = j0;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j0 + u < n_acc) {
          row[u] = __ldg(reinterpret_cast<const float4*>(fb + static_cast<long long>(acc[j0 + u].x) * C));
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j0 + u < n_acc) {
          const float f[4] = {row[u].x, row[u].y, row[u].z, row[u].w};
          bool hit = false;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (f[c] > mx[c]) {
              mx[c] = f[c];
              cnt[c] = 1;
              hit = true;
            } else if (f[c] == mx[c]) {
              ++cnt[c];
              hit = true;
            }
          }
          if (hit && j0 + u < 64) met |= 1ull << (j0 + u);
        }
      }
    }

    // 3. the fused value and its ties: each valid view that does not accept
    // the voxel gives a 0
    const int n_zero = __ldg(rb + V) - n_acc;
    float m[4];
    int t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[c] = mx[c];
      t[c] = cnt[c];
      if (n_zero > 0 && mx[c] < 0.0f) {
        m[c] = 0.0f;
        t[c] = n_zero;
      } else if (n_zero > 0 && mx[c] == 0.0f) {
        t[c] += n_zero;
      }
    }

    // 4. the staged shares of the views that attain m, in view order
    float* ob = dfeats + static_cast<long long>(b) * V * hw * C + sub * 4;
    const float gv[4] = {g.x, g.y, g.z, g.w};
    int tied[4] = {0, 0, 0, 0};
    auto share = [&](const float4& r, int j) {
      const int2 a = acc[j];
      const float f[4] = {r.x, r.y, r.z, r.w};
      float add[4];
      bool any = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        add[c] = 0.0f;  // the untied channels add an exact 0
        if (f[c] == m[c]) {
          const int place = 1 + tied[c] + (m[c] == 0.0f ? a.y : 0);
          const int ex = place == 1 ? t[c] - 1 : t[c] - place + 1;
          add[c] = ldexpf(gv[c], -ex);
          ++tied[c];
          any = true;
        }
      }
      if (any) {
        atomicAdd(reinterpret_cast<float4*>(ob + static_cast<long long>(a.x) * C),
                  make_float4(add[0], add[1], add[2], add[3]));
      }
    };
    for (int j = 0; j < held; ++j) {  // rows no longer held: reload those that can equal m
      if (j < 64 && !(met >> j & 1)) continue;
      share(__ldg(reinterpret_cast<const float4*>(fb + static_cast<long long>(acc[j].x) * C)), j);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (held + u < n_acc) share(row[u], held + u);
    }
    __syncwarp(gmask);  // the group's next voxel rewrites acc
  }
}

// bytes of dynamic shared memory of pass 2: its accepting views (8 bytes a
// view for each group of C / 4 lanes)
long long grad_smem(int V, int C) { return static_cast<long long>(V) * (kGradThreads / (C / 4)) * 8; }

template <int G>
cudaError_t launch_grad(const float* grad, const float* feats, const float* depths, const float* mats,
                        const unsigned char* valid, const int* rank, int B, int V, int X, int Y, int Z,
                        const Intrinsics& k, const int* list, const int* count, float* dfeats, cudaStream_t s) {
  const int smem = static_cast<int>(grad_smem(V, 4 * G));
  // the blocks of one wave on the card, kept for the last device and
  // shared-memory size asked (the queries cost the host more than the launch)
  static int wave_dev = -1, wave_smem = -1, wave = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev != wave_dev || smem != wave_smem)) {
    int per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k3b_grad_pass<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3b_grad_pass<G>, kGradThreads, smem);
    }
    if (err != cudaSuccess) return err;
    wave_dev = dev;
    wave_smem = smem;
    wave = std::max(per_sm, 1) * sms;
  }
  if (err != cudaSuccess) return err;
  // one wave on the card, no more blocks than the longest list needs
  constexpr int kGroups = kGradThreads / G;
  const long long most = (static_cast<long long>(B) * X * Y * Z + kGroups - 1) / kGroups;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(std::min(most, static_cast<long long>(wave))));
  config.blockDim = dim3(kGradThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, k3b_grad_pass<G>, grad, feats, depths, mats, valid, rank, V, X, Y, Z, k, list,
                            count, dfeats);
}

}  // namespace

// Bytes of dynamic shared memory pass 2 needs for V views and C channels
// (32, 64 or 128); the wrapper checks them against the card's limit.
extern "C" long long tpu3dsis_fuse_views_bwd_smem(int V, int C) { return C >= 4 ? grad_smem(V, C) : 0; }

// Calls that launched the kernels so far (pass 1 and pass 2: two kernels a
// call with a non-empty volume).
extern "C" long long tpu3dsis_fuse_views_bwd_launches() { return g_launches; }

// B samples. grad: (B, X, Y, Z, C) float32 cotangent of K3's outputs; feats:
// (B, V, H, W, C) float32; depths: (B, V, H, W) float32; mats: (B, V, 3, 4)
// float32 grid-to-camera rows; margin: (B, V) float32, each view's factor
// on pass 1's inverse-map margin (at least 1: the square of its 3x3's
// condition number); view_valid: (B, V) uint8; valid_rank: (B, V +
// 1) int32, the valid views before each view and their total last; list:
// B * X * Y * Z int32 of scratch; scratch: 1 + ceil(B * X * Y * Z / 32)
// int32 (the list's length, then a bit a voxel), zeroed here; dfeats: (B,
// V, H, W, C) float32, written whole. C = 32, 64 or 128; H, W < 32768; B * V
// * H * W and B * X * Y * Z under 2^31. Returns the cudaError_t.
extern "C" int tpu3dsis_fuse_views_bwd(int B, const void* grad, const void* feats, const void* depths,
                                       const void* mats, const void* margin, const void* view_valid,
                                       const void* valid_rank, int V, int H, int W, int C, int X, int Y, int Z, float fx, float fy, float cx, float cy,
                                       float depth_min, float depth_max, float voxel_size, void* list, void* scratch,
                                       void* dfeats, void* stream) {
  if (C != 32 && C != 64 && C != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = static_cast<long long>(B) * V * H * W * C / 4;
  const long long voxels = static_cast<long long>(B) * X * Y * Z;
  if (voxels == 0) return static_cast<int>(cudaMemsetAsync(dfeats, 0, static_cast<size_t>(n4) * 16, s));
  const Intrinsics k{fx, fy, cx, cy, depth_min, depth_max, voxel_size, H, W};
  const float* mt = static_cast<const float*>(mats);
  const unsigned char* vv = static_cast<const unsigned char*>(view_valid);
  const float* dp = static_cast<const float*>(depths);
  int* lst = static_cast<int*>(list);
  int* scr = static_cast<int*>(scratch);
  cudaError_t err = cudaSuccess;
  if (kPass1) {
    err = cudaMemsetAsync(scr, 0, static_cast<size_t>(1 + (voxels + 31) / 32) * sizeof(int), s);
    // a thread for each of a pixel's lanes and for each float4 of the zero fill
    const long long threads = std::max(static_cast<long long>(B) * V * H * W * kSlabLanes, n4);
    const long long blocks = std::max((threads + kListThreads - 1) / kListThreads, 1LL);
    if (err == cudaSuccess) {
      k3b_list_pass<<<static_cast<unsigned>(blocks), kListThreads, 0, s>>>(dp, mt, static_cast<const float*>(margin),
                                                                           vv, B, V, X, Y, Z, k,
                                                                           static_cast<float4*>(dfeats), n4, lst, scr);
      err = cudaGetLastError();  // else pass 2 would read a list never written
    }
  }
  if (err == cudaSuccess && kPass2 && !kZeroOnly) {
    const float* g = static_cast<const float*>(grad);
    const float* f = static_cast<const float*>(feats);
    const int* rk = static_cast<const int*>(valid_rank);
    float* out = static_cast<float*>(dfeats);
    switch (C) {
      case 32:
        err = launch_grad<8>(g, f, dp, mt, vv, rk, B, V, X, Y, Z, k, lst, scr, out, s);
        break;
      case 64:
        err = launch_grad<16>(g, f, dp, mt, vv, rk, B, V, X, Y, Z, k, lst, scr, out, s);
        break;
      default:
        err = launch_grad<32>(g, f, dp, mt, vv, rk, B, V, X, Y, Z, k, lst, scr, out, s);
    }
  }
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
