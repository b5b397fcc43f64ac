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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kSlices = 2;                              // x-slices of kBY * kBZ = 32 voxels a warp
constexpr int kBX = kWarps * kSlices, kBY = 4, kBZ = 8;  // brick, voxels
constexpr int kThreads = 32 * kWarps;
constexpr float kEps = 1e-3f;        // camera-depth margin, metres
constexpr float kFootprintZ = 0.05f;  // least camera depth of the cut for the pixel-box cull, metres
constexpr int kScanUnroll = 4;        // depths a thread keeps in flight in the box scan
constexpr int kBatch = 4;             // loads a lane keeps in flight in the fuse phase
constexpr unsigned kFull = 0xffffffffu;
// a view's state in the cull
constexpr unsigned char kNone = 0, kKeep = 1, kCulled = 2, kScan = 3;

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

struct Intrinsics {
  float fx, fy, cx, cy, depth_min, depth_max, voxel_size;
  int H, W;
};

// camera coordinates of grid point (x, y, z): the plain version's order
__device__ __forceinline__ float cam_row(const float* m, float x, float y, float z) {
  return ((m[0] * x + m[1] * y) + m[2] * z) + m[3];
}

// rounded pixel coordinate, half to even
__device__ __forceinline__ float pixel(float cam, float f, float zc, float c) { return rintf(cam * f / zc + c); }

// the predicate's projection of one voxel into one view (m: its 12 floats):
// whether its rounded pixel lies in the image with a positive, finite camera
// depth zc, and that flat pixel (0 where not, a pixel that can be read)
__device__ __forceinline__ bool project(const float* m, float x, float y, float z, const Intrinsics& k, int& pix,
                                        float& zc) {
  const float cam_x = cam_row(m, x, y, z);
  const float cam_y = cam_row(m + 4, x, y, z);
  zc = cam_row(m + 8, x, y, z);
  pix = 0;
  if (!(zc > 0.0f && isfinite(zc))) return false;
  const float px = pixel(cam_x, k.fx, zc, k.cx);
  const float py = pixel(cam_y, k.fy, zc, k.cy);
  if (!(px >= 0.0f && px < static_cast<float>(k.W) && py >= 0.0f && py < static_cast<float>(k.H))) return false;
  pix = static_cast<int>(py) * k.W + static_cast<int>(px);
  return true;
}

// the rest of the predicate: the depth d read at that pixel
__device__ __forceinline__ bool depth_accepts(float d, float zc, const Intrinsics& k) {
  return d >= k.depth_min && d <= k.depth_max && fabsf(d - zc) <= k.voxel_size;
}

// Step 1 for one valid view: kKeep, kCulled or kScan with the box
// (x0, x1, y0, y1, inclusive) and depth band to scan.
__device__ __forceinline__ unsigned char cull_view(const float* m, const int lo[3], const int hi[3],
                                                   const Intrinsics& k, short4& box, float2& band) {
  float cam[3][8];
  float zlo = INFINITY, zhi = -INFINITY;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = static_cast<float>(i & 4 ? hi[0] : lo[0]);
    const float y = static_cast<float>(i & 2 ? hi[1] : lo[1]);
    const float z = static_cast<float>(i & 1 ? hi[2] : lo[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      cam[r][i] = cam_row(m + 4 * r, x, y, z);
      finite = finite && isfinite(cam[r][i]);
    }
    zlo = fminf(zlo, cam[2][i]);
    zhi = fmaxf(zhi, cam[2][i]);
  }
  if (!finite) return kKeep;
  band = make_float2(fmaxf(k.depth_min, (zlo - k.voxel_size) - kEps), fminf(k.depth_max, (zhi + k.voxel_size) + kEps));
  if (!(band.x <= band.y)) return kCulled;
  // No voxel with a camera depth below depth_min - voxel_size can accept:
  // the footprint is that of the brick cut at zcut, the corners beyond the
  // cut and the points where the brick's 12 edges cross it.
  const float zcut = fmaxf(zlo, (k.depth_min - k.voxel_size) - kEps);
  if (zcut > kFootprintZ) {
    float pxlo = INFINITY, pxhi = -INFINITY, pylo = INFINITY, pyhi = -INFINITY;
    auto add = [&](float cam_x, float cam_y, float zc) {
      const float px = pixel(cam_x, k.fx, zc, k.cx), py = pixel(cam_y, k.fy, zc, k.cy);
      pxlo = fminf(pxlo, px);
      pxhi = fmaxf(pxhi, px);
      pylo = fminf(pylo, py);
      pyhi = fmaxf(pyhi, py);
    };
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (cam[2][i] >= zcut) add(cam[0][i], cam[1][i], cam[2][i]);
    }
#pragma unroll
    for (int e = 0; e < 12; ++e) {  // edge (i, i | bit), i without the bit
      const int bit = 1 << (e >> 2), low = e & 3;
      const int i = bit == 1 ? low << 1 : bit == 2 ? (low & 1) | ((low & 2) << 1) : low;
      const int j = i | bit;
      if ((cam[2][i] < zcut) != (cam[2][j] < zcut)) {
        const int a = cam[2][i] < zcut ? i : j, b = i + j - a;  // a below the cut, b beyond it
        const float t = (zcut - cam[2][a]) / (cam[2][b] - cam[2][a]);
        add(cam[0][a] + t * (cam[0][b] - cam[0][a]), cam[1][a] + t * (cam[1][b] - cam[1][a]), zcut);
      }
    }
    const float x0 = fmaxf(pxlo - 1.0f, 0.0f), x1 = fminf(pxhi + 1.0f, static_cast<float>(k.W - 1));
    const float y0 = fmaxf(pylo - 1.0f, 0.0f), y1 = fminf(pyhi + 1.0f, static_cast<float>(k.H - 1));
    if (!(x0 <= x1 && y0 <= y1)) return kCulled;
    box = make_short4(static_cast<short>(x0), static_cast<short>(x1), static_cast<short>(y0), static_cast<short>(y1));
  } else {
    box = make_short4(0, static_cast<short>(k.W - 1), 0, static_cast<short>(k.H - 1));
  }
  return kScan;
}

// Step 1's scan, the whole block at once: the pixels of every box of a
// chunk of views, laid end to end (box i from start[i] to start[i + 1]), go
// to the threads in turn, kScanUnroll loads in flight a thread; hit[i] is
// set where a depth of box i lies in its band. A thread walks its (row,
// column) of a box by step[i] = (kThreads / width, kThreads % width) and
// divides only where it enters a box; it reads no more of a box once a hit
// is seen there.
__device__ __forceinline__ void scan_boxes(const float* __restrict__ dv, int hw, int W, const int* start,
                                           const short4* box, const float2* band, const short2* step,
                                           unsigned char* hit) {
  const int total = start[kThreads];
  int seg = 0, r = 0, c = 0, bw = 1;
  bool enter = true;
  for (int p0 = threadIdx.x; p0 < total; p0 += kThreads * kScanUnroll) {
    float d[kScanUnroll];
    int sg[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int p = p0 + u * kThreads;
      d[u] = NAN;
      sg[u] = -1;
      if (p < total) {
        while (p >= start[seg + 1]) {
          ++seg;
          enter = true;
        }
        const short4 b = box[seg];
        if (enter) {
          bw = b.y - b.x + 1;
          const int local = p - start[seg];
          r = local / bw;
          c = local - r * bw;
          enter = false;
        }
        if (!hit[seg]) d[u] = __ldg(dv + static_cast<long long>(seg) * hw + (b.z + r) * W + b.x + c);
        sg[u] = seg;
        c += step[seg].y;
        r += step[seg].x;
        if (c >= bw) {
          c -= bw;
          ++r;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (sg[u] >= 0 && d[u] >= band[sg[u]].x && d[u] <= band[sg[u]].y) hit[sg[u]] = 1;
    }
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
  __shared__ unsigned char s_hit[kThreads];
  __shared__ short4 s_box[kThreads];
  __shared__ float2 s_band[kThreads];
  __shared__ short2 s_step[kThreads];
  __shared__ int s_start[kThreads + 1];
  __shared__ int s_sum[kWarps];
  __shared__ int s_culled;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nby = (Y + kBY - 1) / kBY, nbz = (Z + kBZ - 1) / kBZ;
  const int lo[3] = {static_cast<int>(blockIdx.x / (nby * nbz)) * kBX,
                     static_cast<int>((blockIdx.x / nbz) % nby) * kBY, static_cast<int>(blockIdx.x % nbz) * kBZ};
  const int hi[3] = {min(lo[0] + kBX, X) - 1, min(lo[1] + kBY, Y) - 1, min(lo[2] + kBZ, Z) - 1};
  if (threadIdx.x == 0) s_culled = 0;
  __syncthreads();
  const int hw = k.H * k.W;

  // 1. cull, kThreads views at a time; the kept ones join the list in order
  int ncand = 0;
  for (int base = 0; base < V; base += kThreads) {
    const int v = base + threadIdx.x;
    float m[12];
    unsigned char state = kNone;
    if (v < V && view_valid[v]) {
#pragma unroll
      for (int i = 0; i < 12; ++i) m[i] = __ldg(mats + v * 12 + i);
      state = cull_view(m, lo, hi, k, s_box[threadIdx.x], s_band[threadIdx.x]);
    }
    // the boxes to scan, end to end: an exclusive sum of their areas
    int area = 0;
    if (state == kScan) {
      const short4 b = s_box[threadIdx.x];
      const int bw = b.y - b.x + 1;
      area = bw * (b.w - b.z + 1);
      s_step[threadIdx.x] = make_short2(static_cast<short>(kThreads / bw), static_cast<short>(kThreads % bw));
    }
    int sum = area;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, sum, o);
      if (lane >= o) sum += up;
    }
    if (lane == 31) s_sum[warp] = sum;
    s_hit[threadIdx.x] = 0;
    __syncthreads();
    for (int w = 0; w < warp; ++w) sum += s_sum[w];
    s_start[threadIdx.x + 1] = sum;
    if (threadIdx.x == 0) s_start[0] = 0;
    __syncthreads();
    scan_boxes(depths + static_cast<long long>(base) * hw, hw, k.W, s_start, s_box, s_band, s_step, s_hit);
    __syncthreads();
    if (state == kScan) state = s_hit[threadIdx.x] ? kKeep : kCulled;
    if (state == kCulled) s_culled = 1;
    const unsigned kept = __ballot_sync(kFull, state == kKeep);
    if (lane == 0) s_sum[warp] = __popc(kept);
    __syncthreads();
    int at = ncand + __popc(kept & ((1u << lane) - 1));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += s_sum[w];
      ncand += s_sum[w];
    }
    if (state == kKeep) {
#pragma unroll
      for (int i = 0; i < 12; ++i) s_mat[i * V + at] = m[i];
      s_view[at] = v;
    }
    __syncthreads();
  }
  const bool culled = s_culled != 0;

  // 4. fuse: this warp's x-slices of the brick in turn, a voxel a lane
  for (int x = lo[0] + warp; x <= hi[0]; x += kWarps) {
    const int y = lo[1] + lane / kBZ, z = lo[2] + lane % kBZ;
    const bool live = y <= hi[1] && z <= hi[2];
    unsigned touched = 0;  // the lanes whose voxel some candidate accepts
    for (int c0 = 0; c0 < ncand; c0 += kBatch) {
      bool in[kBatch];
      int pix[kBatch];
      float zc[kBatch], d[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        in[u] = false;
        pix[u] = 0;
        zc[u] = 0.0f;
        if (live && c0 + u < ncand) {
          float m[12];
#pragma unroll
          for (int i = 0; i < 12; ++i) m[i] = s_mat[i * V + c0 + u];
          in[u] = project(m, static_cast<float>(x), static_cast<float>(y), static_cast<float>(z), k, pix[u], zc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        d[u] = c0 + u < ncand ? __ldg(depths + static_cast<long long>(s_view[c0 + u]) * hw + pix[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned acc = __ballot_sync(kFull, in[u] && depth_accepts(d[u], zc[u], k));
        if (lane == 0 && c0 + u < ncand) s_acc[warp * V + c0 + u] = acc;
        touched |= acc;
      }
    }
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
          int pix = 0;
          if (ok) {  // its pixel once more
            float m[12], zc;
#pragma unroll
            for (int i = 0; i < 12; ++i) m[i] = s_mat[i * V + c];
            project(m, static_cast<float>(x), static_cast<float>(yj), static_cast<float>(zj), k, pix, zc);
          }
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
  const long long bricks = static_cast<long long>((X + kBX - 1) / kBX) * ((Y + kBY - 1) / kBY) * ((Z + kBZ - 1) / kBZ);
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
