// K1b: 3D RoI max-pool, backward, for Hopper (sm_90a).
//
// Replaces the VJP of tpu3dsis/ops/roi_pool3d.py::_roi_pool3d_prod
// (_roi_pool3d_prod_bwd, roi_pool3d.py:350, which differentiates the masked,
// staged formulation _pool_one): a bin's output is the max over x, then over
// y, then over z of the voxels in its [start, end) ranges (K1's bin
// arithmetic, in float32 and the same operation order). JAX's max VJP splits
// the cotangent evenly among the tied maxima at each stage, so a voxel's
// share of the cotangent g of bin (px, py, pz) is ((g / n_z) / n_y) / n_x,
// where n_z counts the z-planes of the bin whose (x, y)-max ties the bin's
// max, n_y the rows of that plane whose x-max ties the plane's max, and n_x
// the voxels of that row that tie the row's max. Bins that overlap (by a
// voxel where s/P is not whole) and rois that overlap add up, in float32,
// rounded once to the maps' dtype. An empty bin passes nothing; a roi with
// a batch or level index out of range passes nothing.
//
// What bounds it on this card: bytes, and nearly all of them are the dense
// write of the gradient maps (two 8x24x12x24x128 levels of a training batch,
// 28.3 MB in bf16), most of it zeros: the voxels the rois cover are a few
// MB, which L2 holds. A compare per covered voxel and channel, and an add
// per share, are far below the float32 rate. What stands between a simple
// design and that bound is latency: a share waits on a chain of maxima (x,
// then y, then z) and the loads that feed it, and a voxel sums the shares
// of every column that holds it, in order.
//
// Design: every gradient voxel is written exactly once, by one block, in the
// maps' dtype, with no atomics and no float32 map, and sums its shares in
// the order in which autograd sums the plain version's (the staged masked
// amax of roi_pool3d_staged_plain): per roi, over py into the row's x-max,
// divided by n_x, over px; the rois' parts last roi first. So two launches
// give the same bits, and they match the plain version's float32 sums where
// its reductions run in index order (P <= 4). Two kernels a call:
//   1. column pass, kSplit threads per (roi, column of bins (px, py), 16
//      bytes of channels), each taking every kSplit-th plane and z-bin of
//      the column: each plane of the z-bins' union, its max over the
//      column's rows of each row's x-max, and n_y; each z-bin's max over its
//      planes and g / n_z; each plane's ct, the sum of g / n_z over the
//      z-bins that hold it and whose max it ties, in z-bin order, and
//      ct / n_y. Planes go to an (M, P, P, zcap, C) scratch, zcap the
//      deepest level's L (maxima in the maps' dtype, exact; ct / n_y in
//      float32), z-bins to the block's shared memory; only the planes the
//      rois have are touched, and L2 holds them. kLoads loads in flight;
//   2. brick pass, launched as the column pass's programmatic dependent (its
//      blocks start while the column pass's last ones run, and wait for it
//      with griddepcontrol.wait only where they first read the scratch);
//      persistent blocks, each taking bricks of kBX x kBY x kBZ voxels (and
//      all C channels) in turn. A thread owns one x-row of the brick (its
//      kBX voxels) and 16 bytes of channels (8 bf16 or 4 float32), and keeps
//      their float32 sums in registers:
//      - the block scans the rois a thread each, last window first, and keeps,
//        in index order, those of its sample and level whose bins meet the
//        brick, with the range of their columns that meet it (warp shuffles
//        and two barriers a window); there is no cap on the rois;
//      - once the brick has a roi, it stages its own voxels in shared
//        memory, lists the kept rois' columns (last roi first; px, then py)
//        and stages kPairs of them at a time: each column's planes at the
//        brick's planes, from the scratch, by the whole block at once;
//      - each thread then walks the staged columns in order: where the
//        column's y-bin holds its row and the plane's ct / n_y is nonzero,
//        the row's x-max and n_x over the column's x-bin (once per px; the
//        one stage a brick recomputes: from shared memory where the x-bin
//        lies in the brick, else from L1 and L2), and the sum of the tied
//        ct / n_y; at the end of a px, that sum / n_x to the voxels that tie
//        the row; at the end of a roi, the roi's part to the sums;
//      - one rounding of the sums to the maps' dtype and one 16-byte
//        streaming store (__stcs) per voxel and thread. A brick that no roi
//        meets stores its zeros the same way, after the scan, having read
//        none of the map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kMaxPooled = 8;
constexpr int kBX = 2, kBY = 4, kBZ = 4;  // the brick of voxels one block writes at a time
constexpr int kRows = kBY * kBZ;          // its x-rows, row = (y - y0) * kBZ + (z - z0)
constexpr int kPairs = 8;                 // columns whose planes a block stages at a time
constexpr int kLoads = 4;                 // voxel loads a thread keeps in flight
constexpr int kMaxThreads = 512;
constexpr int kSplit = 4;                 // threads that share a column's planes in the column pass
constexpr int kColumnThreads = 128;
// cut points of tpu3dsis_torch/probe.py (it rebuilds a copy with one flipped)
constexpr bool kZerosOnly = false;
constexpr bool kColumnWalk = true;
constexpr bool kStageRecompute = true;
// the probe's counting build: each block adds up what it computes into its
// slot of g_counts (the column pass: columns, row x-maxima; the brick pass:
// column stagings, row x-maxima), read by tpu3dsis_roi_pool3d_bwd_counts
constexpr bool kCount = false;
constexpr int kCountSlots = 1 << 17;  // blocks counted per kernel

long long g_launches = 0;
__device__ unsigned long long g_counts[4][kCount ? kCountSlots : 1];

// Counting build: the sums of a and b over the block's threads into slot
// blockIdx.x of counters k and k + 1 (one bit at a time, by barrier counts;
// every thread of the block calls it).
__device__ __forceinline__ void count_block(int k, unsigned a, unsigned b) {
  unsigned long long sa = 0, sb = 0;
  for (int bit = 0; bit < 32; ++bit) {
    sa += static_cast<unsigned long long>(__syncthreads_count((a >> bit) & 1u)) << bit;
    sb += static_cast<unsigned long long>(__syncthreads_count((b >> bit) & 1u)) << bit;
  }
  if (threadIdx.x == 0 && blockIdx.x < kCountSlots) {
    g_counts[k][blockIdx.x] = sa;
    g_counts[k + 1][blockIdx.x] = sb;
  }
}

struct Levels {
  const void* feats[kMaxLevels];  // (B, W, H, L, C) channels-last, contiguous
  void* grads[kMaxLevels];        // the same shapes and dtype, written whole
  int w[kMaxLevels], h[kMaxLevels], l[kMaxLevels];
  float scale[kMaxLevels];
  int first[kMaxLevels + 1];  // first brick of each level; first[num] is the bricks' count
  int num, batch;
};

// 16 bytes of channels: loaded raw, unpacked to V float32 values.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int V = 4;
  __device__ static __forceinline__ uint4 raw(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static __forceinline__ void unpack(const uint4& q, float (&v)[V]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static __forceinline__ uint4 bits(const float (&v)[V]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static __forceinline__ float scalar(const float* p) { return __ldg(p); }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static __forceinline__ uint4 raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void unpack(const uint4& q, float (&v)[V]) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // exact for values that came from bf16 (maxima of the map)
  __device__ static __forceinline__ unsigned pack(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  __device__ static __forceinline__ uint4 bits(const float (&v)[V]) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
  __device__ static __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
};

// Bin p of `pooled` along one axis, clamped to [0, extent]; the float32
// expressions of K1 (csrc/roi_pool3d.cu) and _bin_bounds, in their order.
__device__ __forceinline__ void bin_bounds(int p, int pooled, int lo, int hi, int extent, int* start, int* end) {
  const int size = max(hi - lo, 1);
  const float bin = static_cast<float>(size) / static_cast<float>(pooled);
  const int s = static_cast<int>(floorf(static_cast<float>(p) * bin)) + lo;
  const int e = static_cast<int>(ceilf(static_cast<float>(p + 1) * bin)) + lo;
  *start = min(max(s, 0), extent);
  *end = min(max(e, 0), extent);
}

// The roi's [lo, hi) corners on the level, per axis (K1's rounding).
__device__ __forceinline__ void roi_corners(const float* __restrict__ rois, int m, float scale, int (&lo)[3],
                                            int (&hi)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = static_cast<int>(floorf(rois[m * 6 + d] * scale));
    hi[d] = static_cast<int>(ceilf(rois[m * 6 + 3 + d] * scale));
  }
}

// The bins p0 .. p0 + n - 1 along one axis that meet [b0, b1) (the starts
// and the ends both grow with p, so they are consecutive); n = 0 if none
// does or every bin is empty.
__device__ __forceinline__ void bins_meeting(int pooled, int lo, int hi, int extent, int b0, int b1, int* p0,
                                             int* n) {
  int s0, e0, sl, el;
  bin_bounds(0, pooled, lo, hi, extent, &s0, &e0);
  bin_bounds(pooled - 1, pooled, lo, hi, extent, &sl, &el);
  *p0 = 0;
  *n = 0;
  if (el <= s0) return;
  for (int p = 0; p < pooled; ++p) {
    int s, e;
    bin_bounds(p, pooled, lo, hi, extent, &s, &e);
    if (e > b0 && s < b1) {
      if (*n == 0) *p0 = p;
      ++*n;
    }
  }
}

// Folds v into the running max m and its count of ties (first: start anew),
// comparing as the plain version's autograd splits ties.
template <int V>
__device__ __forceinline__ void fold(bool first, const float (&v)[V], float (&m)[V], float (&n)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (first || v[k] > m[k]) {
      m[k] = v[k];
      n[k] = 1.0f;
    } else if (v[k] == m[k]) {
      n[k] += 1.0f;
    }
  }
}

// The max over rows y in [sy, ey) of each row's max over x in [sx, ex) of
// p[x * xs + y * ys], and how many rows tie it; kLoads loads in flight.
// Both ranges non-empty.
template <typename T>
__device__ __forceinline__ void plane_max(const T* p, int xs, int ys, int sx, int ex, int sy, int ey,
                                          float (&fy)[Lane<T>::V], float (&ny)[Lane<T>::V]) {
  constexpr int V = Lane<T>::V;
  const int nx = ex - sx, n = nx * (ey - sy);
  int lx = 0, ly = 0;  // the next voxel to load
  int x = 0, y = 0;    // the next voxel to fold
  float fx[V], cx[V];
  for (int base = 0; base < n; base += kLoads) {
    uint4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u < n) {
        q[u] = Lane<T>::raw(p + (sx + lx) * xs + (sy + ly) * ys);
        if (++lx == nx) {
          lx = 0;
          ++ly;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u < n) {
        float v[V];
        Lane<T>::unpack(q[u], v);
        fold(x == 0, v, fx, cx);
        if (++x == nx) {
          x = 0;
          fold(y == 0, fx, fy, ny);
          ++y;
        }
      }
    }
  }
}

// 1. column pass (see the note at the top): blockDim / (kSplit * C / V)
// columns a block; the block synchronises between the planes, the z-bins
// and the planes' ct.
template <typename T>
__global__ void __launch_bounds__(kColumnThreads)
roi_pool3d_bwd_columns(Levels lv, int C, int P, int zcap, const float* __restrict__ rois,
                       const int* __restrict__ batch_idx, const int* __restrict__ level_idx, int M,
                       const T* __restrict__ cot, T* plane_max_out, float* plane_grad) {
  constexpr int V = Lane<T>::V;
  extern __shared__ uint4 bins_raw[];  // the block's columns' z-bins: g / n_z (float32), then the max
  asm volatile("griddepcontrol.launch_dependents;");  // the brick pass may start: it waits where it reads our planes
  const int lanes = C / V;
  const int per_col = kSplit * lanes;
  const int col = blockIdx.x * (blockDim.x / per_col) + threadIdx.x / per_col;  // (m * P + px) * P + py
  const int part = (threadIdx.x % per_col) / lanes, chan = (threadIdx.x % lanes) * V;
  bool live = threadIdx.x < blockDim.x / per_col * per_col && col < M * P * P;
  int lvl = 0, b = 0, m = 0, px = 0, py = 0;
  int lo[3], hi[3], sx = 0, ex = 0, sy = 0, ey = 0, zu0 = 0, zu1 = 0;
  if (live) {
    py = col % P;
    px = (col / P) % P;
    m = col / (P * P);
    lvl = level_idx[m];
    b = batch_idx[m];
    live = lvl >= 0 && lvl < lv.num && b >= 0 && b < lv.batch;
  }
  if (live) {
    roi_corners(rois, m, lv.scale[lvl], lo, hi);
    int e0, s1;
    bin_bounds(px, P, lo[0], hi[0], lv.w[lvl], &sx, &ex);
    bin_bounds(py, P, lo[1], hi[1], lv.h[lvl], &sy, &ey);
    bin_bounds(0, P, lo[2], hi[2], lv.l[lvl], &zu0, &e0);
    bin_bounds(P - 1, P, lo[2], hi[2], lv.l[lvl], &s1, &zu1);
    live = ex > sx && ey > sy && zu1 > zu0;
  }
  const int H = lv.h[lvl], L = lv.l[lvl];
  const T* map = static_cast<const T*>(lv.feats[lvl]) + static_cast<long long>(b) * lv.w[lvl] * H * L * C + chan;
  // plane z of the column at (z - zu0) * C, z-bin pz at pz * C
  T* fys = plane_max_out + static_cast<long long>(col) * zcap * C + chan;
  float* gys = plane_grad + static_cast<long long>(col) * zcap * C + chan;
  const int local = threadIdx.x / per_col, columns = blockDim.x / per_col;
  float* gzs = reinterpret_cast<float*>(bins_raw) + local * P * C + chan;
  T* fzs = reinterpret_cast<T*>(reinterpret_cast<float*>(bins_raw) + columns * P * C) + local * P * C + chan;
  unsigned row_maxima = 0;  // counting build

  // each plane's max over the column's rows, and n_y
  for (int z = zu0 + part; live && z < zu1; z += kSplit) {
    float fy[V], ny[V];
    if (kCount && chan == 0) row_maxima += ey - sy;
    if (kColumnWalk) {
      plane_max(map + z * C, H * L * C, L * C, sx, ex, sy, ey, fy, ny);
    } else {
      Lane<T>::unpack(Lane<T>::raw(map + z * C + sx * H * L * C + sy * L * C), fy);
#pragma unroll
      for (int k = 0; k < V; ++k) ny[k] = 1.0f;
    }
    *reinterpret_cast<uint4*>(fys + (z - zu0) * C) = Lane<T>::bits(fy);
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(gys + (z - zu0) * C + k) = make_float4(ny[k], ny[k + 1], ny[k + 2], ny[k + 3]);
    }
  }
  __syncthreads();
  // each z-bin's max over its planes and n_z, and g / n_z
  const long long g_at = (static_cast<long long>(m) * C + chan) * P * P * P + (px * P + py) * P;
  for (int pz = part; live && pz < P; pz += kSplit) {
    int zs, ze;
    bin_bounds(pz, P, lo[2], hi[2], L, &zs, &ze);
    if (ze <= zs) continue;
    float g[V];
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] = Lane<T>::scalar(cot + g_at + static_cast<long long>(k) * P * P * P + pz);
    float fz[V], nz[V];
    for (int zq = zs; zq < ze; zq += kLoads) {
      uint4 q[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (zq + u < ze) q[u] = *reinterpret_cast<const uint4*>(fys + (zq + u - zu0) * C);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (zq + u < ze) {
          float v[V];
          Lane<T>::unpack(q[u], v);
          fold(zq + u == zs, v, fz, nz);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] /= nz[k];
    *reinterpret_cast<uint4*>(fzs + pz * C) = Lane<T>::bits(fz);
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(gzs + pz * C + k) = make_float4(g[k], g[k + 1], g[k + 2], g[k + 3]);
    }
  }
  __syncthreads();
  // each plane's ct, the sum of g / n_z over the z-bins that hold it and whose
  // max it ties, in z-bin order, and ct / n_y in place of n_y
  for (int z = zu0 + part; live && z < zu1; z += kSplit) {
    float fy[V], ct[V];
    Lane<T>::unpack(*reinterpret_cast<const uint4*>(fys + (z - zu0) * C), fy);
#pragma unroll
    for (int k = 0; k < V; ++k) ct[k] = 0.0f;
    for (int pz = 0; pz < P; ++pz) {
      int zs, ze;
      bin_bounds(pz, P, lo[2], hi[2], L, &zs, &ze);
      if (z < zs || z >= ze) continue;
      float fz[V];
      Lane<T>::unpack(*reinterpret_cast<const uint4*>(fzs + pz * C), fz);
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(gzs + pz * C + k);
        if (fy[k] == fz[k]) ct[k] += g4.x;
        if (fy[k + 1] == fz[k + 1]) ct[k + 1] += g4.y;
        if (fy[k + 2] == fz[k + 2]) ct[k + 2] += g4.z;
        if (fy[k + 3] == fz[k + 3]) ct[k + 3] += g4.w;
      }
    }
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 n = *reinterpret_cast<const float4*>(gys + (z - zu0) * C + k);
      *reinterpret_cast<float4*>(gys + (z - zu0) * C + k) =
          make_float4(ct[k] / n.x, ct[k + 1] / n.y, ct[k + 2] / n.z, ct[k + 3] / n.w);
    }
  }
  if (kCount) count_block(0, live && part == 0 && chan == 0, row_maxima);
}

// A brick: its level, sample and voxels [x0, x1) x [y0, y1) x [z0, z1).
struct Place {
  int lvl, b, x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ Place place_of(const Levels& lv, int brick) {
  Place q;
  q.lvl = 0;
  while (q.lvl + 1 < lv.num && brick >= lv.first[q.lvl + 1]) ++q.lvl;
  const int W = lv.w[q.lvl], H = lv.h[q.lvl], L = lv.l[q.lvl];
  const int nbx = (W + kBX - 1) / kBX, nby = (H + kBY - 1) / kBY, nbz = (L + kBZ - 1) / kBZ;
  int r = brick - lv.first[q.lvl];
  q.z0 = (r % nbz) * kBZ;
  r /= nbz;
  q.y0 = (r % nby) * kBY;
  r /= nby;
  q.x0 = (r % nbx) * kBX;
  q.b = r / nbx;
  q.x1 = min(q.x0 + kBX, W);
  q.y1 = min(q.y0 + kBY, H);
  q.z1 = min(q.z0 + kBZ, L);
  return q;
}

// Whether roi m passes anything to the brick: it is of the brick's sample
// and level and its bins meet the brick; if so, the range of its columns
// that meet it (4 bits each of px0, npx, py0, npy) and its corners.
__device__ __forceinline__ int roi_columns(const Levels& lv, int P, const float* __restrict__ rois,
                                           const int* __restrict__ batch_idx, const int* __restrict__ level_idx,
                                           int M, int m, const Place& q, int (&lo)[3], int (&hi)[3]) {
  if (m >= M || batch_idx[m] != q.b || level_idx[m] != q.lvl) return 0;
  roi_corners(rois, m, lv.scale[q.lvl], lo, hi);
  int zs0, ze0, zsl, zel;
  bin_bounds(0, P, lo[2], hi[2], lv.l[q.lvl], &zs0, &ze0);
  bin_bounds(P - 1, P, lo[2], hi[2], lv.l[q.lvl], &zsl, &zel);
  if (zel <= zs0 || zs0 >= q.z1 || zel <= q.z0) return 0;  // the z-bins' union misses the brick
  int px0, npx, py0, npy;
  bins_meeting(P, lo[0], hi[0], lv.w[q.lvl], q.x0, q.x1, &px0, &npx);
  bins_meeting(P, lo[1], hi[1], lv.h[q.lvl], q.y0, q.y1, &py0, &npy);
  if (npx == 0 || npy == 0) return 0;
  return px0 | (npx << 4) | (py0 << 8) | (npy << 12);
}

// The row's state in the brick pass: the roi and column whose shares it is
// summing, the row's x-max and n_x over the column's x-bin, the sum over py
// of the tied planes' ct / n_y, and the roi's part of each voxel's sum.
template <int V>
struct RowSum {
  int roi = -1, px = -1, sx = 0, ex = 0;
  bool have_row = false, live = false, touched = false;
  float fx[V], nx[V], t[V];
  float part[kBX][V];
  float acc[kBX][V];
};

// Ends the row's column: its sum / n_x to the voxels that tie the row
// (read from the staged voxels: srow holds x = x0 + i at i * kRows * C).
template <typename T>
__device__ __forceinline__ void end_column(RowSum<Lane<T>::V>& r, const T* srow, int C, int x0, int x1) {
  constexpr int V = Lane<T>::V;
  if (!r.live) return;
  float share[V];
#pragma unroll
  for (int k = 0; k < V; ++k) share[k] = r.t[k] / r.nx[k];
#pragma unroll
  for (int i = 0; i < kBX; ++i) {
    const int x = x0 + i;
    if (x < r.sx || x >= r.ex || x >= x1) continue;
    float v[V];
    Lane<T>::unpack(*reinterpret_cast<const uint4*>(srow + i * kRows * C), v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (v[k] == r.fx[k]) r.part[i][k] += share[k];
    }
  }
  r.live = false;
  r.touched = true;
}

// Ends the row's roi: its part to the sums.
template <int V>
__device__ __forceinline__ void end_roi(RowSum<V>& r) {
  if (r.touched) {
#pragma unroll
    for (int i = 0; i < kBX; ++i) {
#pragma unroll
      for (int k = 0; k < V; ++k) r.acc[i][k] += r.part[i][k];
    }
  }
#pragma unroll
  for (int i = 0; i < kBX; ++i) {
#pragma unroll
    for (int k = 0; k < V; ++k) r.part[i][k] = 0.0f;
  }
  r.touched = false;
}

// 2. brick pass (see the note at the top): persistent blocks, brick b taken
// by block b % gridDim.x.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
roi_pool3d_bwd_bricks(Levels lv, int C, int P, int zcap, const float* __restrict__ rois,
                      const int* __restrict__ batch_idx, const int* __restrict__ level_idx, int M,
                      const T* __restrict__ plane_max, const float* __restrict__ plane_grad) {
  constexpr int V = Lane<T>::V;
  extern __shared__ float smem[];
  __shared__ int2 s_warp[32];       // per warp: kept rois, their columns
  __shared__ int4 s_pair[kPairs][2];  // staged column: (roi, px, py, -), (sx, ex, sy, ey)
  const int window = blockDim.x;  // rois a scan takes at a time, one a thread
  float* s_gy = smem;                                                  // [kPairs][kBZ][C] ct / n_y
  T* s_fy = reinterpret_cast<T*>(s_gy + kPairs * kBZ * C);             // [kPairs][kBZ][C] the plane's max
  T* s_rows = s_fy + kPairs * kBZ * C;                                 // [kBX][kRows][C] the brick's voxels
  int* s_m = reinterpret_cast<int*>(s_rows + kBX * kRows * C);         // kept rois of a window: index,
  int* s_cols = s_m + window;                                          // columns meeting the brick,
  int* s_lohi = s_cols + window;                                       // corners (lo, hi per axis),
  int* s_off = s_lohi + 6 * window;                                    // first column, last roi first

  const int lanes = C / V;
  const int row = threadIdx.x / lanes, chan = (threadIdx.x % lanes) * V;
  const int bricks = lv.first[lv.num];
  bool planes_ready = false;
  unsigned stagings = 0, row_maxima = 0;  // counting build

  for (int brick = blockIdx.x; brick < bricks; brick += gridDim.x) {
    const Place q = place_of(lv, brick);
    const int lvl = q.lvl, b = q.b, x0 = q.x0, x1 = q.x1, y0 = q.y0, y1 = q.y1, z0 = q.z0, z1 = q.z1;
    const int W = lv.w[lvl], H = lv.h[lvl], L = lv.l[lvl];
    const int xs = H * L * C, ys = L * C;
    const int y = y0 + row / kBZ, z = z0 + row % kBZ;
    const bool own = row < kRows && y < y1 && z < z1;
    const long long line_at = static_cast<long long>(b) * W * xs + y * ys + z * C + chan;
    const T* line = static_cast<const T*>(lv.feats[lvl]) + line_at;

    RowSum<V> rs;
#pragma unroll
    for (int i = 0; i < kBX; ++i) {
#pragma unroll
      for (int k = 0; k < V; ++k) rs.acc[i][k] = rs.part[i][k] = 0.0f;
    }
    bool read = false;  // the brick's voxels, staged once it has a roi
    const T* srow = s_rows + row * C + chan;

    for (int w0 = kZerosOnly || M == 0 ? -1 : (M - 1) / window * window; w0 >= 0; w0 -= window) {
      // the thread's roi of the window, if it is of this sample and level and
      // its bins meet the brick, and its columns that meet it
      const int m = w0 + threadIdx.x;
      int lo[3], hi[3];
      const int cols = roi_columns(lv, P, rois, batch_idx, level_idx, M, m, q, lo, hi);
      const int kept = cols != 0, pairs = ((cols >> 4) & 15) * ((cols >> 12) & 15);
      // prefix sums of the kept rois and their columns over the block: each
      // warp's by shuffles, then the warps' totals
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
      int ik = kept, ip = pairs;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, ik, o), c = __shfl_up_sync(0xffffffffu, ip, o);
        if (lane >= o) {
          ik += a;
          ip += c;
        }
      }
      if (lane == 31) s_warp[warp] = make_int2(ik, ip);
      __syncthreads();
      int pos = ik - kept, pp = ip - pairs, nkept = 0, npairs = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int2 t = s_warp[w];
        if (w < warp) {
          pos += t.x;
          pp += t.y;
        }
        nkept += t.x;
        npairs += t.y;
      }
      // kept rois in index order; the first column of each, last roi first
      if (kept) {
        s_m[pos] = m;
        s_cols[pos] = cols;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          s_lohi[pos * 6 + d] = lo[d];
          s_lohi[pos * 6 + 3 + d] = hi[d];
        }
        s_off[nkept - 1 - pos] = npairs - pp - pairs;
      }
      if (nkept > 0 && !read) {
        const T* base = static_cast<const T*>(lv.feats[lvl]) + static_cast<long long>(b) * W * xs;
        for (int it = threadIdx.x; it < (x1 - x0) * kRows * lanes; it += blockDim.x) {
          const int ch = (it % lanes) * V, rr = (it / lanes) % kRows, xi = it / (lanes * kRows);
          const int yy = y0 + rr / kBZ, zz = z0 + rr % kBZ;
          if (yy < y1 && zz < z1) {
            *reinterpret_cast<uint4*>(s_rows + (xi * kRows + rr) * C + ch) =
                Lane<T>::raw(base + (x0 + xi) * xs + yy * ys + zz * C + ch);
          }
        }
        read = true;
      }
      __syncthreads();

      if (kCount && threadIdx.x == 0) stagings += npairs;
      if (npairs > 0 && !planes_ready) {  // the column pass, launched before, has written every plane
        asm volatile("griddepcontrol.wait;" ::: "memory");
        planes_ready = true;
      }
      for (int k0 = 0; k0 < npairs; k0 += kPairs) {
        // stage: item (j, q, lane) reads plane z0 + q of column k0 + j
        for (int it = threadIdx.x; it < kPairs * kBZ * lanes; it += blockDim.x) {
          const int ch = (it % lanes) * V, q = (it / lanes) % kBZ, j = it / (lanes * kBZ);
          const int kk = k0 + j, zq = z0 + q;
          uint4 fy = make_uint4(0, 0, 0, 0);
          float4 g[V / 4];
#pragma unroll
          for (int k = 0; k < V / 4; ++k) g[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (kk < npairs) {
            int lo_r = 0, hi_r = nkept;  // the rank whose columns hold kk
            while (hi_r - lo_r > 1) {
              const int mid = (lo_r + hi_r) >> 1;
              if (s_off[mid] <= kk) lo_r = mid; else hi_r = mid;
            }
            const int slot = nkept - 1 - lo_r, cols = s_cols[slot], local = kk - s_off[lo_r];
            const int npy = (cols >> 12) & 15;
            const int px = (cols & 15) + local / npy, py = ((cols >> 8) & 15) + local % npy;
            const int* lh = s_lohi + slot * 6;
            int sx, ex, sy, ey, zu0, e0, s1, zu1;
            bin_bounds(px, P, lh[0], lh[3], W, &sx, &ex);
            bin_bounds(py, P, lh[1], lh[4], H, &sy, &ey);
            bin_bounds(0, P, lh[2], lh[5], L, &zu0, &e0);
            bin_bounds(P - 1, P, lh[2], lh[5], L, &s1, &zu1);
            if (ex > sx && ey > sy && zq < z1 && zq >= zu0 && zq < zu1) {
              const long long at = ((static_cast<long long>(s_m[slot] * P + px) * P + py) * zcap + zq - zu0) * C + ch;
              fy = __ldcg(reinterpret_cast<const uint4*>(plane_max + at));
#pragma unroll
              for (int k = 0; k < V / 4; ++k) g[k] = __ldcg(reinterpret_cast<const float4*>(plane_grad + at) + k);
            }
            if (q == 0 && ch == 0) {
              s_pair[j][0] = make_int4(s_m[slot], px, py, 0);
              s_pair[j][1] = make_int4(sx, ex, sy, ey);
            }
          }
          *reinterpret_cast<uint4*>(s_fy + (j * kBZ + q) * C + ch) = fy;
#pragma unroll
          for (int k = 0; k < V / 4; ++k) reinterpret_cast<float4*>(s_gy + (j * kBZ + q) * C + ch)[k] = g[k];
        }
        __syncthreads();

        // each row's shares, column by column in order
        if (own) {
          const int ncols = min(kPairs, npairs - k0);
          for (int j = 0; j < ncols; ++j) {
            const int4 id = s_pair[j][0], d = s_pair[j][1];
            if (id.x != rs.roi) {
              end_column<T>(rs, srow, C, x0, x1);
              end_roi(rs);
              rs.roi = id.x;
              rs.px = -1;
            }
            if (id.y != rs.px) {
              end_column<T>(rs, srow, C, x0, x1);
              rs.px = id.y;
              rs.sx = d.x;
              rs.ex = d.y;
              rs.have_row = false;
            }
            if (d.y <= d.x || y < d.z || y >= d.w) continue;  // an empty column, or the row is not in it
            const int at = (j * kBZ + z - z0) * C + chan;
            float gy[V], fy[V];
            bool nonzero = false;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              gy[k] = s_gy[at + k];
              nonzero |= gy[k] != 0.0f;
            }
            if (!nonzero) continue;  // the plane ties no z-bin's max in any of these channels
            Lane<T>::unpack(*reinterpret_cast<const uint4*>(s_fy + at), fy);
            if (!rs.have_row) {
              if (kCount && chan == 0) ++row_maxima;
              if (kStageRecompute) {
                if (rs.sx >= x0 && rs.ex <= x1) {  // from the staged voxels
                  for (int x = rs.sx; x < rs.ex; ++x) {
                    float v[V];
                    Lane<T>::unpack(*reinterpret_cast<const uint4*>(srow + (x - x0) * kRows * C), v);
                    fold(x == rs.sx, v, rs.fx, rs.nx);
                  }
                } else {  // an x-bin past the brick: from L1 and L2, kLoads in flight
                  for (int x = rs.sx; x < rs.ex; x += kLoads) {
                    uint4 q[kLoads];
#pragma unroll
                    for (int u = 0; u < kLoads; ++u) {
                      if (x + u < rs.ex) q[u] = Lane<T>::raw(line + (x + u) * xs);
                    }
#pragma unroll
                    for (int u = 0; u < kLoads; ++u) {
                      if (x + u < rs.ex) {
                        float v[V];
                        Lane<T>::unpack(q[u], v);
                        fold(x + u == rs.sx, v, rs.fx, rs.nx);
                      }
                    }
                  }
                }
              } else {
                Lane<T>::unpack(Lane<T>::raw(line + rs.sx * xs), rs.fx);
#pragma unroll
                for (int k = 0; k < V; ++k) rs.nx[k] = 1.0f;
              }
#pragma unroll
              for (int k = 0; k < V; ++k) rs.t[k] = 0.0f;
              rs.have_row = true;
            }
#pragma unroll
            for (int k = 0; k < V; ++k) {
              if (rs.fx[k] == fy[k]) rs.t[k] += gy[k];
            }
            rs.live = true;
          }
        }
        __syncthreads();  // the next columns are staged over these
      }
    }
    end_column<T>(rs, srow, C, x0, x1);
    end_roi(rs);

    if (own) {
      T* out = static_cast<T*>(lv.grads[lvl]) + line_at;
#pragma unroll
      for (int i = 0; i < kBX; ++i) {
        if (x0 + i < x1) __stcs(reinterpret_cast<uint4*>(out + (x0 + i) * xs), Lane<T>::bits(rs.acc[i]));
      }
    }
  }
  if (kCount) count_block(2, stagings, row_maxima);
}

int vec_of(int is_bf16) { return is_bf16 ? Lane<__nv_bfloat16>::V : Lane<float>::V; }

int threads_of(int is_bf16, int C) { return (kRows * (C / vec_of(is_bf16)) + 31) / 32 * 32; }

long long smem_of(int is_bf16, int C) {
  const long long item = is_bf16 ? 2 : 4;
  const long long stage = static_cast<long long>(kPairs) * kBZ * C * (sizeof(float) + item);
  const long long rows = static_cast<long long>(kBX) * kRows * C * item;
  return stage + rows + 9LL * threads_of(is_bf16, C) * static_cast<long long>(sizeof(int));
}

template <typename T>
cudaError_t launch(const Levels& lv, int C, int P, int zcap, const float* rois, const int* batch_idx,
                   const int* level_idx, int M, const T* cot, T* plane_max, float* plane_grad, int threads,
                   cudaStream_t s) {
  const int per_block = max(1, kColumnThreads / (kSplit * (C / Lane<T>::V))), columns = M * P * P;
  cudaError_t err = cudaSuccess;
  if (kCount) {
    void* counts = nullptr;
    err = cudaGetSymbolAddress(&counts, g_counts);
    if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, sizeof(g_counts), s);
    if (err != cudaSuccess) return err;
  }
  if (columns > 0 && !kZerosOnly) {
    const size_t bins = static_cast<size_t>(per_block) * P * C * (sizeof(float) + sizeof(T));
    roi_pool3d_bwd_columns<T><<<(columns + per_block - 1) / per_block, per_block * kSplit * (C / Lane<T>::V), bins,
                                s>>>(lv, C, P, zcap, rois, batch_idx, level_idx, M, cot, plane_max, plane_grad);
    err = cudaGetLastError();  // else the brick pass would read a scratch never written
    if (err != cudaSuccess) return err;
  }
  const long long smem = smem_of(std::is_same<T, __nv_bfloat16>::value, C);
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(roi_pool3d_bwd_bricks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, roi_pool3d_bwd_bricks<T>, threads,
                                                        static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return err;
  // launched as the column pass's dependent: its blocks start as the column
  // pass's last blocks run, and store the bricks no roi meets meanwhile
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(min(lv.first[lv.num], max(per_sm, 1) * sms));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  const T* pm = plane_max;
  const float* pg = plane_grad;
  return cudaLaunchKernelEx(&config, roi_pool3d_bwd_bricks<T>, lv, C, P, zcap, rois, batch_idx, level_idx, M, pm,
                            pg);
}

}  // namespace

// Threads of one brick block for C channels: a thread per (brick row, 16
// bytes of channels), rounded up to whole warps; above 512 the wrapper
// refuses C.
extern "C" int tpu3dsis_roi_pool3d_bwd_threads(int is_bf16, int C) { return threads_of(is_bf16, C); }

// Bytes of dynamic shared memory one brick block needs; the wrapper checks
// them against the card's limit.
extern "C" long long tpu3dsis_roi_pool3d_bwd_smem(int is_bf16, int C) { return smem_of(is_bf16, C); }

// Calls that launched the kernels so far (the column pass, when there are
// rois, and the brick pass: two kernels a call).
extern "C" long long tpu3dsis_roi_pool3d_bwd_launches() { return g_launches; }

// The probe's counting build (kCount), after a call: out[0] the columns the
// column pass computed, out[1] the row x-maxima it computed, out[2] the
// columns the brick pass staged (one per brick that meets the column), out[3]
// the row x-maxima the brick pass recomputed; the first kCountSlots blocks of
// each kernel. Waits for the card. Returns the cudaError_t
// (cudaErrorNotSupported in a build that does not count).
extern "C" int tpu3dsis_roi_pool3d_bwd_counts(long long* out) {
  if (!kCount) return static_cast<int>(cudaErrorNotSupported);
  static unsigned long long host[4][kCount ? kCountSlots : 1];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_counts, sizeof(host));
  for (int k = 0; k < 4; ++k) {
    out[k] = 0;
    for (int i = 0; err == cudaSuccess && i < (kCount ? kCountSlots : 1); ++i) out[k] += host[k][i];
  }
  return static_cast<int>(err);
}

// feats: num_levels pointers to (batch, W, H, L, C) contiguous maps, float32
// or bfloat16, 16-byte aligned, C a multiple of 16 bytes of channels; grads:
// as many maps of the same shapes and dtype, which the kernels write whole;
// whl: W, H, L of each level; scales: spatial scale of each level; rois:
// (M, 6) float32; batch_idx, level_idx: (M,) int32 (level 0-based); cot: the
// (M, C, P, P, P) cotangent of K1's output, feats' type; plane_max,
// plane_grad: (M, P, P, zcap, C) scratch of feats' type and of float32,
// zcap the largest L of the levels, 16-byte aligned. P must be 1 to 8 (the
// wrapper checks). Returns the cudaError_t.
extern "C" int tpu3dsis_roi_pool3d_bwd(int is_bf16, int num_levels, const void* const* feats, void* const* grads,
                                       const int* whl, const float* scales, int batch, int C, const void* rois,
                                       const void* batch_idx, const void* level_idx, int M, int P, const void* cot,
                                       void* plane_max, void* plane_grad, int zcap, void* stream) {
  const int threads = threads_of(is_bf16, C);
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || P > kMaxPooled || C % vec_of(is_bf16) != 0 ||
      threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  lv.num = num_levels;
  lv.batch = batch;
  lv.first[0] = 0;
  for (int i = 0; i < num_levels; ++i) {
    lv.feats[i] = feats[i];
    lv.grads[i] = grads[i];
    lv.w[i] = whl[3 * i];
    lv.h[i] = whl[3 * i + 1];
    lv.l[i] = whl[3 * i + 2];
    lv.scale[i] = scales[i];
    const long long bricks = static_cast<long long>((lv.w[i] + kBX - 1) / kBX) * ((lv.h[i] + kBY - 1) / kBY) *
                             ((lv.l[i] + kBZ - 1) / kBZ);
    lv.first[i + 1] = lv.first[i] + static_cast<int>(batch * bricks);
  }
  if (lv.first[num_levels] == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* li = static_cast<const int*>(level_idx);
  float* pg = static_cast<float*>(plane_grad);
  const cudaError_t err =
      is_bf16 ? launch(lv, C, P, zcap, r, bi, li, M, static_cast<const __nv_bfloat16*>(cot),
                       static_cast<__nv_bfloat16*>(plane_max), pg, threads, s)
              : launch(lv, C, P, zcap, r, bi, li, M, static_cast<const float*>(cot), static_cast<float*>(plane_max),
                       pg, threads, s);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
