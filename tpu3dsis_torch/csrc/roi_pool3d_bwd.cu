// K1b: 3D RoI max-pool, backward, for Hopper (sm_90a).
//
// Replaces the VJP of tpu3dsis/ops/roi_pool3d.py::_roi_pool3d_prod (its
// custom_vjp, which differentiates the masked, staged formulation _pool_one):
// a bin's output is the max over x, then over y, then over z of the voxels
// in its [start, end) ranges (K1's bin arithmetic, in float32 and the same
// operation order). JAX's max VJP splits the cotangent evenly among the tied
// maxima at each stage, so a voxel's share of the cotangent g of bin
// (px, py, pz) is ((g / n_z) / n_y) / n_x, where n_z counts the z-planes of
// the bin whose (x, y)-max ties the bin's max, n_y the rows of that plane
// whose x-max ties the plane's max, and n_x the voxels of that row that tie
// the row's max. The shares are added with float32 atomics into a zeroed
// float32 map per level (the wrapper casts it to the maps' dtype): bins that
// overlap (by a voxel where s/P is not whole) and rois that overlap add up.
// An empty bin passes nothing; a roi with a batch or level index out of
// range passes nothing.
//
// What bounds it on this card: bytes. It must write the gradient maps (two
// 8x24x12x24x128 levels of a training batch, 14 MB in bf16) and read the
// cotangent and the voxels the rois cover; the float32 accumulation map it
// adds into is zeroed and cast by the wrapper, which at least triples the
// bytes that reach device memory. Within the kernel the work is small: one
// compare per covered voxel and channel to recompute the maxima, a second
// pass over the planes that hold a bin's max, and one atomic per share.
//
// Design (a simple, correct first version):
//   - one block per (roi, column (px, py)) of bins, blockIdx = (px*P+py, m),
//     a thread per channel (C threads, at most 256, each walking every
//     blockDim-th channel), so a warp reads 32 consecutive channels of a
//     voxel at once;
//   - pass 1: for every z of the z-bins' union, the plane's max over the
//     column's y-rows of each row's x-max (fy) and the count of rows that tie
//     it (n_y), in shared memory;
//   - pass 2: per z-bin, its max over fy and the count of planes that tie
//     it (n_z); each tied plane gets g / n_z added to its cotangent (ct), as
//     the broadcast sum of the JAX/torch VJP adds the z-bins that share a
//     plane;
//   - pass 3: for every plane with a nonzero ct, each row whose x-max ties
//     the plane's max gets ct / n_y, which the voxels that tie the row's max
//     share: ct / n_y / n_x each, one atomicAdd per voxel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kMaxPooled = 8;
constexpr int kMaxThreads = 256;
// cut points of tpu3dsis_torch/probe.py (it rebuilds a copy with one false)
constexpr bool kRecomputeMaxima = true;
constexpr bool kAtomicAdds = true;

long long g_launches = 0;

struct Levels {
  const void* feats[kMaxLevels];  // (B, W, H, L, C) channels-last, contiguous
  float* grads[kMaxLevels];       // the same shape, float32, zeroed
  int w[kMaxLevels], h[kMaxLevels], l[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// Bin p of `pooled` along one axis, clamped to [0, extent]; the float32
// expressions of K1 (csrc/roi_pool3d.cu) and _bin_bounds, in their order.
__device__ __forceinline__ void bin_bounds(int p, int pooled, int lo, int hi,
                                           int extent, int* start, int* end) {
  const int size = max(hi - lo, 1);
  const float bin = static_cast<float>(size) / static_cast<float>(pooled);
  const int s = static_cast<int>(floorf(static_cast<float>(p) * bin)) + lo;
  const int e = static_cast<int>(ceilf(static_cast<float>(p + 1) * bin)) + lo;
  *start = min(max(s, 0), extent);
  *end = min(max(e, 0), extent);
}

// Max of row[x * xs] over x in [sx, ex) (ex > sx) and how many voxels tie it.
template <typename T>
__device__ __forceinline__ float row_max(const T* row, long long xs, int sx, int ex, float* count) {
  float m = load(row + sx * xs);
  float n = 1.0f;
  for (int x = sx + 1; x < ex; ++x) {
    const float v = load(row + x * xs);
    if (v > m) {
      m = v;
      n = 1.0f;
    } else if (v == m) {
      n += 1.0f;
    }
  }
  *count = n;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
roi_pool3d_bwd_kernel(Levels lv, int batch, int C, int P, const float* __restrict__ rois,
                      const int* __restrict__ batch_idx, const int* __restrict__ level_idx,
                      const T* __restrict__ cot, int zcap) {
  extern __shared__ float smem[];  // fy, n_y, ct: zcap rows of blockDim floats each
  __shared__ int bounds[3][2][kMaxPooled];

  const int m = blockIdx.y;
  const int px = blockIdx.x / P, py = blockIdx.x % P;
  const int lvl = level_idx[m];
  const int b = batch_idx[m];
  if (lvl < 0 || lvl >= lv.num || b < 0 || b >= batch) return;
  const int W = lv.w[lvl], H = lv.h[lvl], L = lv.l[lvl];
  if (threadIdx.x < 3 * P) {
    const int d = threadIdx.x / P, p = threadIdx.x % P;
    const float scale = lv.scale[lvl];
    const int lo = static_cast<int>(floorf(rois[m * 6 + d] * scale));
    const int hi = static_cast<int>(ceilf(rois[m * 6 + 3 + d] * scale));
    bin_bounds(p, P, lo, hi, d == 0 ? W : (d == 1 ? H : L), &bounds[d][0][p], &bounds[d][1][p]);
  }
  __syncthreads();
  const int sx = bounds[0][0][px], ex = bounds[0][1][px];
  const int sy = bounds[1][0][py], ey = bounds[1][1][py];
  // the z-bins' union: starts and ends both grow with p (see K1)
  const int z0 = bounds[2][0][0], z1 = bounds[2][1][P - 1];
  if (ex <= sx || ey <= sy || z1 <= z0) return;  // every bin of the column is empty

  const long long xs = static_cast<long long>(H) * L * C, ys = static_cast<long long>(L) * C;
  const long long base = static_cast<long long>(b) * W * xs;
  const T* map = static_cast<const T*>(lv.feats[lvl]) + base;
  float* grad = lv.grads[lvl] + base;
  const int stride = blockDim.x;
  float* s_fy = smem + threadIdx.x;
  float* s_ny = s_fy + zcap * stride;
  float* s_ct = s_ny + zcap * stride;

  for (int c = threadIdx.x; c < C; c += stride) {
    // pass 1: per plane, the max over the rows of each row's x-max, and n_y
    for (int z = z0; z < z1; ++z) {
      float fy = 0.0f, ny = 1.0f;
      if (kRecomputeMaxima) {
        for (int y = sy; y < ey; ++y) {
          float nx;
          const float fx = row_max(map + y * ys + z * C + c, xs, sx, ex, &nx);
          if (y == sy || fx > fy) {
            fy = fx;
            ny = 1.0f;
          } else if (fx == fy) {
            ny += 1.0f;
          }
        }
      } else {
        fy = load(map + sx * xs + sy * ys + z * C + c);
      }
      s_fy[(z - z0) * stride] = fy;
      s_ny[(z - z0) * stride] = ny;
      s_ct[(z - z0) * stride] = 0.0f;
    }
    // pass 2: per z-bin, its max, n_z, and g / n_z to each plane that ties it
    for (int pz = 0; pz < P; ++pz) {
      const int s = bounds[2][0][pz], e = bounds[2][1][pz];
      if (e <= s) continue;
      const float g = load(cot + ((static_cast<long long>(m) * C + c) * P * P + px * P + py) * P + pz);
      if (g == 0.0f) continue;
      float fz = s_fy[(s - z0) * stride], nz = 1.0f;
      for (int z = s + 1; z < e; ++z) {
        const float v = s_fy[(z - z0) * stride];
        if (v > fz) {
          fz = v;
          nz = 1.0f;
        } else if (v == fz) {
          nz += 1.0f;
        }
      }
      const float gz = g / nz;
      for (int z = s; z < e; ++z) {
        if (s_fy[(z - z0) * stride] == fz) s_ct[(z - z0) * stride] += gz;
      }
    }
    // pass 3: each plane's cotangent to the rows that tie its max, then to
    // the voxels that tie each such row's max
    for (int z = z0; z < z1; ++z) {
      const float ct = s_ct[(z - z0) * stride];
      if (ct == 0.0f) continue;
      const float fy = s_fy[(z - z0) * stride];
      const float gy = ct / s_ny[(z - z0) * stride];
      for (int y = sy; y < ey; ++y) {
        const T* row = map + y * ys + z * C + c;
        float nx = 1.0f;
        const float fx = kRecomputeMaxima ? row_max(row, xs, sx, ex, &nx) : fy;
        if (fx != fy) continue;
        const float gx = gy / nx;
        float* out = grad + y * ys + z * C + c;
        for (int x = sx; x < ex; ++x) {
          if (load(row + x * xs) == fx) {
            if (kAtomicAdds) {
              atomicAdd(out + x * xs, gx);
            } else {
              out[x * xs] = gx;
            }
          }
        }
      }
    }
  }
}

int threads_for(int C) { return min(kMaxThreads, (C + 31) / 32 * 32); }

template <typename T>
cudaError_t launch(const Levels& lv, int batch, int C, int P, const float* rois, const int* batch_idx,
                   const int* level_idx, int M, const T* cot, int zcap, long long smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(roi_pool3d_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P * P, M);
  roi_pool3d_bwd_kernel<T><<<grid, threads_for(C), smem, s>>>(lv, batch, C, P, rois, batch_idx, level_idx, cot,
                                                              zcap);
  return cudaGetLastError();
}

}  // namespace

// Threads of one block for C channels.
extern "C" int tpu3dsis_roi_pool3d_bwd_threads(int C) { return threads_for(C); }

// Bytes of dynamic shared memory one block needs when the largest level has
// L = zcap; the wrapper checks it against the card's limit.
extern "C" long long tpu3dsis_roi_pool3d_bwd_smem(int C, int zcap) {
  return 3LL * zcap * threads_for(C) * static_cast<long long>(sizeof(float));
}

// Kernel launches so far (one per call that had rois).
extern "C" long long tpu3dsis_roi_pool3d_bwd_launches() { return g_launches; }

// feats: num_levels pointers to (batch, W, H, L, C) contiguous maps, float32
// or bfloat16; grads: as many zeroed float32 maps of the same shapes; whl: W,
// H, L of each level; scales: spatial scale of each level; rois: (M, 6)
// float32; batch_idx, level_idx: (M,) int32 (level 0-based); cot: the
// (M, C, P, P, P) cotangent of K1's output, feats' type; zcap: the largest L
// of the levels. P must be 1 to 8 (the wrapper checks). Returns the
// cudaError_t.
extern "C" int tpu3dsis_roi_pool3d_bwd(int is_bf16, int num_levels, const void* const* feats,
                                       void* const* grads, const int* whl, const float* scales, int batch,
                                       int C, const void* rois, const void* batch_idx, const void* level_idx,
                                       int M, int P, const void* cot, int zcap, void* stream) {
  if (M == 0) return static_cast<int>(cudaSuccess);
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || P > kMaxPooled) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.feats[i] = feats[i];
    lv.grads[i] = static_cast<float*>(grads[i]);
    lv.w[i] = whl[3 * i];
    lv.h[i] = whl[3 * i + 1];
    lv.l[i] = whl[3 * i + 2];
    lv.scale[i] = scales[i];
  }
  const long long smem = tpu3dsis_roi_pool3d_bwd_smem(C, zcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* li = static_cast<const int*>(level_idx);
  const cudaError_t err =
      is_bf16 ? launch(lv, batch, C, P, r, bi, li, M, static_cast<const __nv_bfloat16*>(cot), zcap, smem, s)
              : launch(lv, batch, C, P, r, bi, li, M, static_cast<const float*>(cot), zcap, smem, s);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
