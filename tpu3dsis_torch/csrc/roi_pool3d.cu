// K1: 3D RoI max-pool, forward, for Hopper (sm_90a).
//
// Replaces tpu3dsis/ops/roi_pool3d_pallas.py::roi_pool3d_pallas (and its XLA
// twin tpu3dsis/ops/roi_pool3d.py::roi_pool3d): every roi (scene voxels) is
// scaled by its level's 1/stride, floor(lo) / ceil(hi), its size clamped to at
// least 1, and cut into P^3 bins [floor(p*s/P), ceil((p+1)*s/P)) + lo clamped
// to the map. Each output is the max over its bin (NaN if the bin holds a
// NaN), or 0 for an empty bin. The bin arithmetic is float32, in the same
// operation order as _bin_bounds / _axis_bins, and the library is built with
// --fmad=false, so the result is bit-exact against the plain version.
//
// What bounds it on this card: bytes, and on the way to them the loads that
// L1 and L2 must serve. It does one compare per voxel and channel; it must
// write M*C*P^3 outputs (105 MB in bf16 for 6400 rois of 128 channels) and
// read the voxels the rois cover, which a chunk's two level maps hold (3.5 MB
// in bf16, so L2 serves the re-reads of neighbouring rois). Neighbouring bins
// overlap by a voxel where s/P is not whole, so pooling bin by bin loads a
// roi's voxels about (1.25)^3 = 2 times over, each load a dependent round
// trip. The TPU kernel pinned the map in VMEM; here the map stays in device
// memory, every byte moves in full 16-byte vectors, and the design cuts the
// loads and keeps many in flight.
//
// Design:
//   - one block of 256 threads per roi, rois in order (m = b*R + r), so the
//     rois of one chunk run together and share its maps in L2; the roi's
//     3 x P bin bounds are computed once, into shared memory;
//   - each level is its own (B, W, H, L, C) channels-last map with its own
//     W/H/L (no stacked copy of the levels);
//   - the work item is a column of bins (px, py), all P of its z-bins: its
//     lanes walk the column's x-bin by y-bin rectangle once for every z of
//     the z-bins' union, so no voxel is loaded twice for the z overlap, and
//     fold each z-plane's max into the z-bins that hold that plane. A lane
//     owns 16 bytes of channels (8 bf16 or 4 float32): in bf16 with C = 128
//     a half-warp covers one voxel, so a warp pools two columns and one load
//     instruction reads two whole voxels. The walk is one flat loop over
//     (z, x, y), unrolled by kUnroll across plane ends, so kUnroll loads are
//     in flight however small the bins. The columns of a roi walk z
//     together, so the voxels their rectangles share (the x and y overlap)
//     are re-read from L1 within a plane or two. The max is max.NaN, so a
//     NaN voxel gives NaN as torch.amax and jnp.max do;
//   - a lane ends with P consecutive bins (the z-bins) of each of its
//     channels and writes them, one vector per channel, to a shared (C, P^3)
//     tile. Tile row of channel chunk*VEC + k is k*(C/VEC) + chunk, so the
//     lanes of a half-warp write consecutive rows, and the row pitch is an
//     odd number of 16-byte units against bank conflicts;
//   - the tile of one roi is contiguous in the (M, C, P, P, P) output, so the
//     block writes it with coalesced 16-byte streaming stores, which keep the
//     output from evicting the level maps from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks per SM the register budget must allow
constexpr int kMaxLevels = 3;
constexpr int kUnroll = 4;

long long g_launches = 0;

struct Levels {
  const void* feats[kMaxLevels];  // (B, W, H, L, C) channels-last, contiguous
  int w[kMaxLevels], h[kMaxLevels], l[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

// Lane-wise arithmetic on 16 bytes of channels held as 4 x 32 bits.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  static constexpr unsigned kNegInf = 0xff800000u;
  static constexpr unsigned kNaN = 0x7fc00000u;
  __device__ static __forceinline__ unsigned vmax(unsigned a, unsigned b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
    return __float_as_uint(d);
  }
  // 32-bit word i of "channel k over the P bins of acc"
  template <int P>
  __device__ static __forceinline__ unsigned gather(const unsigned (&acc)[P][4], int k, int i) {
    return acc[i][k];
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  static constexpr unsigned kNegInf = 0xff80ff80u;
  static constexpr unsigned kNaN = 0x7fc07fc0u;
  __device__ static __forceinline__ unsigned vmax(unsigned a, unsigned b) {
    unsigned d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // channel k of bins 2i and 2i+1
  template <int P>
  __device__ static __forceinline__ unsigned gather(const unsigned (&acc)[P][4], int k, int i) {
    return __byte_perm(acc[2 * i][k / 2], acc[2 * i + 1][k / 2], (k & 1) ? 0x7632 : 0x5410);
  }
};

// 16-byte units in one tile row (one channel over all P^3 bins), made odd so
// that the rows of consecutive lanes fall in different bank groups.
__host__ __device__ inline int tile_pitch(int bins, int vec) {
  const int pitch = bins / vec + 1;
  return pitch + !(pitch & 1);
}

// Bin p of `pooled` along one axis, clamped to [0, extent]; the float32
// expressions of _bin_bounds, in its order.
__device__ __forceinline__ void bin_bounds(int p, int pooled, int lo, int hi,
                                           int extent, int* start, int* end) {
  const int size = max(hi - lo, 1);
  const float bin = static_cast<float>(size) / static_cast<float>(pooled);
  const int s = static_cast<int>(floorf(static_cast<float>(p) * bin)) + lo;
  const int e = static_cast<int>(ceilf(static_cast<float>(p + 1) * bin)) + lo;
  *start = min(max(s, 0), extent);
  *end = min(max(e, 0), extent);
}

// acc[p] = max(acc[p], m) for every z-bin p that holds plane z.
template <typename T, int P>
__device__ __forceinline__ void fold_plane(unsigned (&acc)[P][4], const unsigned (&m)[4], int z,
                                           const int (&zlo)[P], const int (&zhi)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (z >= zlo[p] && z < zhi[p]) {
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[p][w] = Vec<T>::vmax(acc[p][w], m[w]);
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_pool3d_kernel(Levels lv, int batch, int C, const float* __restrict__ rois,
                  const int* __restrict__ batch_idx,
                  const int* __restrict__ level_idx, T* __restrict__ out) {
  using V = Vec<T>;
  constexpr int kVec = V::kWidth;
  constexpr int kBins = P * P * P;
  constexpr int kRowUnits = kBins / kVec;  // 16-byte units of one channel's bins
  constexpr int kColWords = P * static_cast<int>(sizeof(T)) / 4;  // one channel of a column
  extern __shared__ uint4 tile[];          // C rows x tile_pitch units
  __shared__ int bounds[3][2][P];

  const int m = blockIdx.x;
  const int units = C * kRowUnits;  // of the roi's whole output tile
  uint4* dst = reinterpret_cast<uint4*>(out) + static_cast<long long>(m) * units;

  const int lvl = level_idx[m];
  const int b = batch_idx[m];
  if (lvl < 0 || lvl >= lv.num || b < 0 || b >= batch) {
    // an index the caller should never pass: make it visible, read nothing
    const uint4 nan = make_uint4(V::kNaN, V::kNaN, V::kNaN, V::kNaN);
    for (int f = threadIdx.x; f < units; f += kThreads) dst[f] = nan;
    return;
  }
  const int W = lv.w[lvl], H = lv.h[lvl], L = lv.l[lvl];
  if (threadIdx.x < 3 * P) {
    const int d = threadIdx.x / P, p = threadIdx.x % P;
    const float scale = lv.scale[lvl];
    const int lo = static_cast<int>(floorf(rois[m * 6 + d] * scale));
    const int hi = static_cast<int>(ceilf(rois[m * 6 + 3 + d] * scale));
    bin_bounds(p, P, lo, hi, d == 0 ? W : (d == 1 ? H : L), &bounds[d][0][p],
               &bounds[d][1][p]);
  }
  __syncthreads();

  const int chunks = C / kVec;            // 16-byte chunks of one voxel
  const int lanes = min(chunks, 32);      // lanes of one column
  const int per_warp = 32 / lanes;        // columns a warp pools at once
  const int lane = threadIdx.x & 31;
  const int pitch = tile_pitch(kBins, kVec);
  const T* map = static_cast<const T*>(lv.feats[lvl]) +
                 static_cast<long long>(b) * W * H * L * C;
  int zlo[P], zhi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    zlo[p] = bounds[2][0][p];
    zhi[p] = bounds[2][1][p];
  }
  // the z-bins' union: starts and ends both grow with p, and each bin starts
  // no later than the previous one ends
  const int z0 = zlo[0], nz = zhi[P - 1] - zlo[0];

  for (int col = (threadIdx.x >> 5) * per_warp + lane / lanes; col < P * P;
       col += kWarps * per_warp) {
    const int px = col / P, py = col % P;
    const int sx = bounds[0][0][px], nx = bounds[0][1][px] - sx;
    const int sy = bounds[1][0][py], ny = bounds[1][1][py] - sy;
    const int n = (nx > 0 && ny > 0 && nz > 0) ? nx * ny * nz : 0;
    for (int chunk = lane % lanes; chunk < chunks; chunk += lanes) {
      unsigned acc[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[p][w] = V::kNegInf;
      }
      if (n > 0) {
        const T* corner = map + ((sx * H + sy) * L) * C + chunk * kVec;
        unsigned mx[4] = {V::kNegInf, V::kNegInf, V::kNegInf, V::kNegInf};
        int plane = z0;  // the z-plane mx holds
        int dx = 0, dy = 0, z = z0;
        for (int v = 0; v < n; v += kUnroll) {
          uint4 x[kUnroll];
          int zu[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            x[u] = __ldg(reinterpret_cast<const uint4*>(corner + ((dx * H + dy) * L + z) * C));
            zu[u] = z;
            if (v + u + 1 < n) {  // else load this voxel again: max is idempotent
              if (++dy == ny) {
                dy = 0;
                if (++dx == nx) {
                  dx = 0;
                  ++z;
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (zu[u] != plane) {
              fold_plane<T, P>(acc, mx, plane, zlo, zhi);
              plane = zu[u];
#pragma unroll
              for (int w = 0; w < 4; ++w) mx[w] = V::kNegInf;
            }
            mx[0] = V::vmax(mx[0], x[u].x);
            mx[1] = V::vmax(mx[1], x[u].y);
            mx[2] = V::vmax(mx[2], x[u].z);
            mx[3] = V::vmax(mx[3], x[u].w);
          }
        }
        fold_plane<T, P>(acc, mx, plane, zlo, zhi);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (n == 0 || zhi[p] <= zlo[p]) {  // empty bin
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[p][w] = 0u;
        }
      }
      // channel chunk*kVec + k, bins col*P .. col*P + P-1 of its tile row
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        unsigned* row = reinterpret_cast<unsigned*>(tile + (k * chunks + chunk) * pitch) + col * kColWords;
        if constexpr (kColWords == 4) {
          *reinterpret_cast<uint4*>(row) =
              make_uint4(V::template gather<P>(acc, k, 0), V::template gather<P>(acc, k, 1),
                         V::template gather<P>(acc, k, 2), V::template gather<P>(acc, k, 3));
        } else if constexpr (kColWords == 2) {
          *reinterpret_cast<uint2*>(row) =
              make_uint2(V::template gather<P>(acc, k, 0), V::template gather<P>(acc, k, 1));
        } else {
#pragma unroll
          for (int i = 0; i < kColWords; ++i) row[i] = V::template gather<P>(acc, k, i);
        }
      }
    }
  }
  __syncthreads();

  for (int f = threadIdx.x; f < units; f += kThreads) {
    const int c = f / kRowUnits;
    const int row = (c % kVec) * chunks + c / kVec;
    __stcs(dst + f, tile[row * pitch + f % kRowUnits]);
  }
}

int vec_width(int is_bf16) { return is_bf16 ? 8 : 4; }

template <typename T>
cudaError_t launch(int P, const Levels& lv, int batch, int C, const float* rois,
                   const int* batch_idx, const int* level_idx, int M, T* out,
                   long long smem, cudaStream_t s) {
  void (*kernel)(Levels, int, int, const float*, const int*, const int*, T*);
  switch (P) {
    case 2: kernel = roi_pool3d_kernel<T, 2>; break;
    case 4: kernel = roi_pool3d_kernel<T, 4>; break;
    case 6: kernel = roi_pool3d_kernel<T, 6>; break;
    case 8: kernel = roi_pool3d_kernel<T, 8>; break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<M, kThreads, smem, s>>>(lv, batch, C, rois, batch_idx, level_idx, out);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
extern "C" long long tpu3dsis_roi_pool3d_smem(int is_bf16, int C, int P) {
  const int bins = P * P * P;
  return static_cast<long long>(C) * tile_pitch(bins, vec_width(is_bf16)) * 16;
}

// Kernel launches so far (one per call that had rois).
extern "C" long long tpu3dsis_roi_pool3d_launches() { return g_launches; }

// feats: num_levels pointers to (batch, W, H, L, C) contiguous maps, float32
// or bfloat16, 16-byte aligned; whl: W, H, L of each level; scales: spatial
// scale of each level; rois: (M, 6) float32; batch_idx, level_idx: (M,) int32
// (level 0-based); out: (M, C, P, P, P), feats' type. C must be a multiple of
// 16 bytes of channels, C / that 1-32 or a multiple of 32, and P one of 2, 4,
// 6, 8 (the wrapper checks). Returns the cudaError_t.
extern "C" int tpu3dsis_roi_pool3d(int is_bf16, int num_levels,
                                   const void* const* feats, const int* whl,
                                   const float* scales, int batch, int C,
                                   const void* rois, const void* batch_idx,
                                   const void* level_idx, int M, int P,
                                   void* out, void* stream) {
  if (M == 0) return static_cast<int>(cudaSuccess);
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.feats[i] = feats[i];
    lv.w[i] = whl[3 * i];
    lv.h[i] = whl[3 * i + 1];
    lv.l[i] = whl[3 * i + 2];
    lv.scale[i] = scales[i];
  }
  const long long smem = tpu3dsis_roi_pool3d_smem(is_bf16, C, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* li = static_cast<const int*>(level_idx);
  const cudaError_t err =
      is_bf16 ? launch(P, lv, batch, C, r, bi, li, M, static_cast<__nv_bfloat16*>(out), smem, s)
              : launch(P, lv, batch, C, r, bi, li, M, static_cast<float*>(out), smem, s);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
