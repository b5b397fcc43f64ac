// K2: greedy 3D NMS keep mask, batched, for Hopper (sm_90a).
//
// Replaces tpu3dsis/ops/nms.py::nms_mask (an XLA program: a tiled exact
// greedy with a certified fixpoint inside each tile). Same semantics: boxes
// are sorted by descending score; IoU uses +1 extents
// (tpu3dsis/geometry/boxes.py::nms_overlap, same operation order, so the
// float32 IoU is bit-identical to the plain version's); an earlier kept box
// suppresses a later one when IoU > thresh; invalid boxes are never kept and
// never suppress.
//
// What bounds it on this card: latency, not bytes or FLOPs. A chunk has
// N = 400 boxes, so the IoU matrix is 160k pairs and the mask 22 KB; what
// costs is the greedy scan, N dependent steps. A plain PyTorch greedy NMS on
// the card issues several kernel launches for each of those steps.
//
// Design: the reference's own bitmask scheme
// (lib/layer_utils/nms/src/cuda/nms_kernel.cu), with the keep scan moved from
// the host onto the device so there is no sync and no copy to the host.
//   1. nms_mask_kernel: one block of 64 threads per (row tile, column tile,
//      sample), upper-triangular tiles only. Thread i writes the 64-bit word
//      "box i suppresses box j" for the 64 boxes j of the column tile.
//   2. nms_scan_kernel: one block per sample copies its (N, ceil(N/64)) mask
//      into shared memory; one warp then walks the boxes in order, keeping
//      the running "removed" bitset in shared memory and OR-ing in the row of
//      each kept box, one word per lane.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;

// +1-extent IoU of box a (earlier) with box b (later), boxes.py:137-173.
__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  const float va = (a[3] - a[0] + 1.0f) * (a[4] - a[1] + 1.0f) *
                   (a[5] - a[2] + 1.0f);
  const float vb = (b[3] - b[0] + 1.0f) * (b[4] - b[1] + 1.0f) *
                   (b[5] - b[2] + 1.0f);
  const float iw = fmaxf(fminf(a[3], b[3]) - fmaxf(a[0], b[0]) + 1.0f, 0.0f);
  const float ih = fmaxf(fminf(a[4], b[4]) - fmaxf(a[1], b[1]) + 1.0f, 0.0f);
  const float il = fmaxf(fminf(a[5], b[5]) - fmaxf(a[2], b[2]) + 1.0f, 0.0f);
  const float inter = iw * ih * il;
  return inter / (va + vb - inter);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const bool* __restrict__ valid, int N,
                                int col_blocks, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int row_tile = blockIdx.y;
  const int col_tile = blockIdx.x;
  if (row_tile > col_tile) return;  // the scan reads only j >= i tiles
  const long long b = blockIdx.z;
  const int row_size = min(N - row_tile * kTile, kTile);
  const int col_size = min(N - col_tile * kTile, kTile);
  const float* bb = boxes + b * N * 6;
  const bool* vb = valid + b * N;

  __shared__ float col_boxes[kTile * 6];
  __shared__ bool col_valid[kTile];
  const int t = threadIdx.x;
  if (t < col_size) {
    const int j = col_tile * kTile + t;
    for (int k = 0; k < 6; ++k) col_boxes[t * 6 + k] = bb[j * 6 + k];
    col_valid[t] = vb[j];
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_tile * kTile + t;
  float cur[6];
  for (int k = 0; k < 6; ++k) cur[k] = bb[i * 6 + k];
  unsigned long long bits = 0;
  if (vb[i]) {
    const int start = row_tile == col_tile ? t + 1 : 0;
    for (int j = start; j < col_size; ++j) {
      if (col_valid[j] && iou_plus1(cur, col_boxes + j * 6) > thresh) {
        bits |= 1ULL << j;
      }
    }
  }
  mask[(b * N + i) * col_blocks + col_tile] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const bool* __restrict__ valid, int N,
                                int col_blocks, bool* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* rows = smem;                  // N * col_blocks
  unsigned long long* removed = smem + N * col_blocks;  // col_blocks
  const long long b = blockIdx.x;
  const unsigned long long* m = mask + b * N * col_blocks;
  for (int k = threadIdx.x; k < N * col_blocks; k += blockDim.x) {
    rows[k] = m[k];
  }
  for (int k = threadIdx.x; k < col_blocks; k += blockDim.x) removed[k] = 0;
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const bool* vb = valid + b * N;
  bool* kb = keep + b * N;
  for (int i = 0; i < N; ++i) {
    const int word = i / kTile;
    const bool kept = !((removed[word] >> (i % kTile)) & 1ULL) && vb[i];
    __syncwarp();  // every lane has read removed[word] before any lane ORs
    if (lane == 0) kb[i] = kept;
    if (kept) {
      for (int j = word + lane; j < col_blocks; j += 32) {
        removed[j] |= rows[i * col_blocks + j];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Bytes of shared memory the scan needs for N boxes; the wrapper checks it
// against the card's limit before launching.
extern "C" long long tpu3dsis_nms3d_scan_smem(int N) {
  const long long col_blocks = (N + kTile - 1) / kTile;
  return (static_cast<long long>(N) + 1) * col_blocks * 8;
}

// boxes: (B, N, 6) float32; valid: (B, N) bool; mask: (B, N, ceil(N/64))
// 64-bit scratch; keep: (B, N) bool output. Returns the cudaError_t.
extern "C" int tpu3dsis_nms3d(const void* boxes, const void* valid, int B,
                              int N, float thresh, void* mask, void* keep,
                              void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (N + kTile - 1) / kTile;
  const dim3 grid(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid), N,
      col_blocks, thresh, static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long smem = tpu3dsis_nms3d_scan_smem(N);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<B, 256, static_cast<size_t>(smem), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const bool*>(valid), N, col_blocks,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}
