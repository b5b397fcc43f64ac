// Device code shared by K3 (fuse_views.cu) and its backward K3b
// (fuse_views_bwd.cu): the brick decomposition, the acceptance predicate's
// projection and the per-brick view cull. Both kernels decide which voxels a
// view accepts, and at which pixel, with these same float32 operations, so
// the backward differentiates exactly the forward's choices (K3b finds its
// voxels without the cull, which only skips views that reject). Each source
// includes this header and builds into a library of its own.
//
// The predicate (tpu3dsis_torch/geometry/projection.py::_project): a voxel
// accepts a view when its rounded pixel lies in the image with a positive,
// finite camera depth zc, and the depth d read there satisfies depth_min <=
// d <= depth_max and |d - zc| <= voxel_size. Built with --fmad=false and IEEE
// division; rintf rounds half to even as torch.round and jnp.round do.
//
// The cull (step 1 of fuse_views.cu's design note, whose step 2 says why its
// margins are safe): per brick of kBX x kBY x kBZ voxels, every valid view
// is projected at the brick's corners; a view whose depth band or pixel
// footprint rules out every voxel of the brick is culled, the others are
// compacted in view order into a shared-memory candidate list. A culled view
// is still a valid view: it rejects every voxel of the brick.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fuse_views_common {

constexpr int kWarps = 4;
constexpr int kSlices = 2;                              // x-slices of kBY * kBZ = 32 voxels a warp
constexpr int kBX = kWarps * kSlices, kBY = 4, kBZ = 8;  // brick, voxels
constexpr int kThreads = 32 * kWarps;
constexpr float kEps = 1e-3f;        // camera-depth margin, metres
constexpr float kFootprintZ = 0.05f;  // least camera depth of the cut for the pixel-box cull, metres
constexpr int kScanUnroll = 4;        // depths a thread keeps in flight in the box scan
constexpr int kBatch = 4;             // loads a lane keeps in flight while it walks a voxel's views
constexpr unsigned kFull = 0xffffffffu;
// a view's state in the cull
constexpr unsigned char kNone = 0, kKeep = 1, kCulled = 2, kScan = 3;

struct Intrinsics {
  float fx, fy, cx, cy, depth_min, depth_max, voxel_size;
  int H, W;
};

// first and last voxel of brick b (z fastest, the volume's channel-last order)
__device__ __forceinline__ void brick_of(unsigned b, int X, int Y, int Z, int lo[3], int hi[3]) {
  const int nby = (Y + kBY - 1) / kBY, nbz = (Z + kBZ - 1) / kBZ;
  lo[0] = static_cast<int>(b / (nby * nbz)) * kBX;
  lo[1] = static_cast<int>((b / nbz) % nby) * kBY;
  lo[2] = static_cast<int>(b % nbz) * kBZ;
  hi[0] = min(lo[0] + kBX, X) - 1;
  hi[1] = min(lo[1] + kBY, Y) - 1;
  hi[2] = min(lo[2] + kBZ, Z) - 1;
}

inline long long n_bricks(int X, int Y, int Z) {
  return static_cast<long long>((X + kBX - 1) / kBX) * ((Y + kBY - 1) / kBY) * ((Z + kBZ - 1) / kBZ);
}

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

// One valid view against one brick: kKeep, kCulled or kScan with the box
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

// The cull's shared-memory state, one per block.
struct CullScratch {
  unsigned char hit[kThreads];
  short4 box[kThreads];
  float2 band[kThreads];
  short2 step[kThreads];
  int start[kThreads + 1];
  int sum[kWarps];
  int culled;
};

// The box scan, the whole block at once: the pixels of every box of a
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

// The cull of one brick, called by every thread of the block: the views
// kept, in view order, go to the candidate list (candidate c's matrix float
// i at s_mat[i * V + c], its view at s_view[c]). Returns the number of
// candidates; `culled` is set when a valid view was culled. With kCull false
// every valid view is a candidate (the probe's "no cull" copy).
template <bool kCull>
__device__ __forceinline__ int cull_brick(const float* __restrict__ depths, const float* __restrict__ mats,
                                          const unsigned char* __restrict__ view_valid, int V, const int lo[3],
                                          const int hi[3], const Intrinsics& k, float* s_mat, int* s_view,
                                          CullScratch& cs, bool& culled) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = k.H * k.W;
  if (threadIdx.x == 0) cs.culled = 0;
  __syncthreads();
  int ncand = 0;
  for (int base = 0; base < V; base += kThreads) {
    const int v = base + threadIdx.x;
    float m[12];
    unsigned char state = kNone;
    if (v < V && view_valid[v]) {
#pragma unroll
      for (int i = 0; i < 12; ++i) m[i] = __ldg(mats + v * 12 + i);
      state = kCull ? cull_view(m, lo, hi, k, cs.box[threadIdx.x], cs.band[threadIdx.x]) : kKeep;
    }
    // the boxes to scan, end to end: an exclusive sum of their areas
    int area = 0;
    if (state == kScan) {
      const short4 b = cs.box[threadIdx.x];
      const int bw = b.y - b.x + 1;
      area = bw * (b.w - b.z + 1);
      cs.step[threadIdx.x] = make_short2(static_cast<short>(kThreads / bw), static_cast<short>(kThreads % bw));
    }
    int sum = area;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, sum, o);
      if (lane >= o) sum += up;
    }
    if (lane == 31) cs.sum[warp] = sum;
    cs.hit[threadIdx.x] = 0;
    __syncthreads();
    for (int w = 0; w < warp; ++w) sum += cs.sum[w];
    cs.start[threadIdx.x + 1] = sum;
    if (threadIdx.x == 0) cs.start[0] = 0;
    __syncthreads();
    scan_boxes(depths + static_cast<long long>(base) * hw, hw, k.W, cs.start, cs.box, cs.band, cs.step, cs.hit);
    __syncthreads();
    if (state == kScan) state = cs.hit[threadIdx.x] ? kKeep : kCulled;
    if (state == kCulled) cs.culled = 1;
    const unsigned kept = __ballot_sync(kFull, state == kKeep);
    if (lane == 0) cs.sum[warp] = __popc(kept);
    __syncthreads();
    int at = ncand + __popc(kept & ((1u << lane) - 1));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += cs.sum[w];
      ncand += cs.sum[w];
    }
    if (state == kKeep) {
#pragma unroll
      for (int i = 0; i < 12; ++i) s_mat[i * V + at] = m[i];
      s_view[at] = v;
    }
    __syncthreads();
  }
  culled = cs.culled != 0;
  return ncand;
}

// Step 4's first half for one x-slice of a brick, by one warp, a voxel a
// lane: bit j of s_acc[c] is set where candidate c accepts voxel j of the
// slice (y = lo[1] + j / kBZ, z = lo[2] + j % kBZ). Returns the lanes whose
// voxel some candidate accepts.
__device__ __forceinline__ unsigned accept_ballots(const float* __restrict__ depths, const float* s_mat,
                                                   const int* s_view, int V, int ncand, int x, const int lo[3],
                                                   const int hi[3], const Intrinsics& k, unsigned* s_acc) {
  const int lane = threadIdx.x & 31;
  const int hw = k.H * k.W;
  const int y = lo[1] + lane / kBZ, z = lo[2] + lane % kBZ;
  const bool live = y <= hi[1] && z <= hi[2];
  unsigned touched = 0;
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
      if (lane == 0 && c0 + u < ncand) s_acc[c0 + u] = acc;
      touched |= acc;
    }
  }
  return touched;
}

// The pixel of candidate c for voxel (x, y, z), once more with the same
// operations (the caller knows the candidate accepts it).
__device__ __forceinline__ int candidate_pixel(const float* s_mat, int V, int c, int x, int y, int z,
                                               const Intrinsics& k) {
  float m[12], zc;
  int pix;
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = s_mat[i * V + c];
  project(m, static_cast<float>(x), static_cast<float>(y), static_cast<float>(z), k, pix, zc);
  return pix;
}

}  // namespace fuse_views_common
