// K2: greedy 3D NMS keep mask, batched, for Hopper (sm_90a).
//
// Replaces tpu3dsis/ops/nms.py::nms_mask (an XLA program: a tiled exact
// greedy with a certified fixpoint inside each tile). Same semantics: boxes
// are sorted by descending score; IoU uses +1 extents
// (tpu3dsis/geometry/boxes.py::nms_overlap, same operation order, built with
// --fmad=false, so the float32 IoU is bit-identical to the plain version's);
// an earlier kept box suppresses a later one when IoU > thresh; invalid boxes
// are never kept and never suppress. With a classes operand (the class-aware
// mode of the whole-scene stitch, nms.py:101-104) a box suppresses only boxes
// of its own class; the IoU stays that of the raw boxes.
//
// What bounds it on this card: neither bytes nor FLOPs at the card's scale,
// but the few SMs that one sample can use. A chunk has N = 400 boxes (10 KB)
// and N(N-1)/2 = 80k box pairs: too few IoU tests to fill the card, too many
// for one SM to finish quickly; and then the greedy walk, N dependent steps
// on one warp. Most of its time goes to the pair tests, then to the walk
// (tpu3dsis_torch/probe.py times each part).
//
// Design: one launch; a cluster of kCluster = 2 blocks of 512 threads per
// sample; nothing through device memory but the boxes in and the keep mask
// out.
//   1. Every block of the cluster stages the sample's boxes (with their
//      +1-extent volumes), a bitset of the valid ones and, in the class-aware
//      mode, their classes in shared memory.
//   2. The blocks share the upper-triangular suppression bitmask, the
//      reference's scheme (lib/layer_utils/nms/src/cuda/nms_kernel.cu): word
//      w of row i holds "box i suppresses box j" for the 64 boxes j of word
//      w, j > i (and, class-aware, of box i's class). A thread computes one
//      (row, word); the 32 lanes of a warp take 32 rows of one word, so they
//      read each box j together. The words
//      go straight into the shared memory of the cluster's first block
//      (distributed shared memory), so two SMs build one sample's mask. The
//      test "IoU > thresh" needs no division and no branch (`suppresses`),
//      so the tests of several pairs overlap.
//   3. In the first block, one warp walks the boxes. Lane w keeps word w of
//      the "removed" bitset in a register. For the 64 boxes of word w, the
//      current word comes to every lane once by __shfl_sync, and the walk is
//      a chain of 64 steps unrolled over its bits: "if bit t is clear, OR
//      row t's word w into the current word, and row t's word `lane` into the
//      lane's own", the rows read from shared memory ahead of the chain. A
//      box whose bit is still clear when the chain passes it is kept. The
//      keep bits go to shared memory once per word, and the block stores the
//      keep mask with coalesced byte stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 2;
constexpr int kWord = 64;
constexpr int kMaxWords = 32;  // one word of "removed" per lane of the walk

long long g_launches = 0;

__host__ __device__ inline int words(int n) { return (n + kWord - 1) / kWord; }

// Box as two float4: (x0, y0, z0, x1), (y1, z1, +1-extent volume, unused).
// The +1-extent intersection of box a (earlier) and box b (later), in
// boxes.py:137-173's order of operations.
__device__ __forceinline__ float intersection(float4 a0, float4 a1, float4 b0, float4 b1) {
  const float iw = fmaxf(fminf(a0.w, b0.w) - fmaxf(a0.x, b0.x) + 1.0f, 0.0f);
  const float ih = fmaxf(fminf(a1.x, b1.x) - fmaxf(a0.y, b0.y) + 1.0f, 0.0f);
  const float il = fmaxf(fminf(a1.y, b1.y) - fmaxf(a0.z, b0.z) + 1.0f, 0.0f);
  return iw * ih * il;
}

// "Box a suppresses box b": their IoU inter / union above thresh. The
// float32 quotient rounds above thresh exactly when inter > mid * union,
// where `mid` is the midpoint of thresh and the next float32 up, or
// inter == mid * union and `tie_up` (the next float32 is the even one, ties
// to even); exact in float64 (at most 26 x 24 significant bits). That holds
// when inter > 0 (then union > 0) and the union is finite; 0 / union is
// never above a thresh >= 0. Branch-free, so that the compiler overlaps the
// tests of several pairs; `decided` turns false for a pair this cannot
// decide (an infinite union, a NaN, a negative thresh), which
// `suppresses_by_division` then decides.
__device__ __forceinline__ bool suppresses(float4 a0, float4 a1, float4 b0, float4 b1,
                                          float thresh, double mid, bool tie_up,
                                          bool& decided) {
  const float inter = intersection(a0, a1, b0, b1);
  const float uni = a1.z + b1.z - inter;
  const double p = mid * static_cast<double>(uni);
  const double q = static_cast<double>(inter);
  const bool overlap = (inter > 0.0f) & (uni < INFINITY);
  decided &= overlap | ((inter == 0.0f) & (thresh >= 0.0f));
  return overlap & ((q > p) | ((q == p) & tie_up));
}

__device__ bool suppresses_by_division(float4 a0, float4 a1, float4 b0, float4 b1, float thresh) {
  const float inter = intersection(a0, a1, b0, b1);
  return inter / (a1.z + b1.z - inter) > thresh;
}

// kClasses: the class-aware mode, `classes` (B, N) int32; without it the
// kernel never reads `classes` and is the class-agnostic one.
template <bool kClasses>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms3d_kernel(const float* __restrict__ boxes, const bool* __restrict__ valid,
             const int* __restrict__ classes, int N, float thresh, double mid,
             bool tie_up, bool* __restrict__ keep) {
  extern __shared__ float4 smem[];
  const int cb = words(N);
  float4* box = smem;                                              // 2N
  unsigned long long* rows =
      reinterpret_cast<unsigned long long*>(smem + 2 * N);         // N x cb
  unsigned long long* valid_words = rows + static_cast<long long>(N) * cb;  // cb
  unsigned long long* keep_words = valid_words + cb;               // cb
  int* cls = reinterpret_cast<int*>(keep_words + cb);              // N, class-aware only

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long s = blockIdx.x / kCluster;
  const float* bb = boxes + s * N * 6;
  const bool* vb = valid + s * N;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float c[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = bb[i * 6 + k];
    const float vol = (c[3] - c[0] + 1.0f) * (c[4] - c[1] + 1.0f) * (c[5] - c[2] + 1.0f);
    box[2 * i] = make_float4(c[0], c[1], c[2], c[3]);
    box[2 * i + 1] = make_float4(c[4], c[5], vol, 0.0f);
    if (kClasses) cls[i] = classes[s * N + i];
  }
  // cb * 64 is a multiple of 32, so every warp runs the ballot whole
  for (int i = threadIdx.x; i < cb * kWord; i += kThreads) {
    const unsigned bits = __ballot_sync(0xffffffffu, i < N && vb[i]);
    if ((i & 31) == 0) reinterpret_cast<unsigned*>(valid_words)[i / 32] = bits;
  }
  cluster.sync();  // also: every block has started before any writes to another

  // (word w, row i) items, w-major: word w has rows 0 .. min(64(w+1), N)-1;
  // words w < i/64 of row i are never read. The cluster's blocks take them
  // in turn and write them into the first block's rows.
  unsigned long long* first_rows = cluster.map_shared_rank(rows, 0);
  const int items = 32 * (cb - 1) * cb + N;
  int w = 0, first = 0;  // first item of word w
  for (int k = rank * kThreads + threadIdx.x; k < items; k += kCluster * kThreads) {
    while (k >= first + min(kWord * (w + 1), N)) {
      first += min(kWord * (w + 1), N);
      ++w;
    }
    const int i = k - first;
    unsigned long long bits = 0;
    if ((valid_words[i / kWord] >> (i % kWord)) & 1ull) {
      const float4 a0 = box[2 * i], a1 = box[2 * i + 1];
      const int j0 = w * kWord;
      const float4* bj = box + 2 * j0;
      // every box of the word, unrolled so that several IoUs are in
      // flight; only the valid boxes j > i count
      const int n = min(kWord, N - j0);
      bool decided = true;
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        bits |= static_cast<unsigned long long>(
                    suppresses(a0, a1, bj[2 * t], bj[2 * t + 1], thresh, mid, tie_up, decided))
                << t;
      }
      if (!decided) {  // rare: the whole row again, by division
        bits = 0;
        for (int t = 0; t < n; ++t) {
          const bool sup = suppresses_by_division(a0, a1, bj[2 * t], bj[2 * t + 1], thresh);
          bits |= static_cast<unsigned long long>(sup) << t;
        }
      }
      if (kClasses) {  // only boxes of box i's class
        const int ci = cls[i];
        const int* cj = cls + j0;
        unsigned long long same = 0;
#pragma unroll 8
        for (int t = 0; t < n; ++t) same |= static_cast<unsigned long long>(cj[t] == ci) << t;
        bits &= same;
      }
      bits &= valid_words[w];  // 0 past N
      if (i >= j0) bits &= i - j0 == kWord - 1 ? 0ull : ~0ull << (i - j0 + 1);
    }
    first_rows[static_cast<long long>(i) * cb + w] = bits;
  }
  cluster.sync();  // the mask is whole in the first block
  if (rank != 0) return;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int own = lane < cb ? lane : 0;  // lanes past the last word read word 0
    unsigned long long removed = 0;  // word `lane` of the removed set
    for (int cw = 0; cw < cb; ++cw) {
      // invalid boxes count as removed: never kept, and their rows are 0.
      // Lanes <= cw OR words of rows that were never written into their own
      // word, which no later step reads.
      unsigned long long cur = __shfl_sync(0xffffffffu, removed, cw) | ~valid_words[cw];
      const unsigned long long* word_rows = rows + static_cast<long long>(cw) * kWord * cb;
      const int n = min(kWord, N - cw * kWord);
      if (n == kWord) {
#pragma unroll
        for (int t = 0; t < kWord; ++t) {
          const unsigned long long r = word_rows[t * cb + cw], o = word_rows[t * cb + own];
          if (!(cur & (1ull << t))) {
            cur |= r;
            removed |= o;
          }
        }
      } else {
        for (int t = 0; t < n; ++t) {
          const unsigned long long r = word_rows[t * cb + cw], o = word_rows[t * cb + own];
          if (!(cur & (1ull << t))) {
            cur |= r;
            removed |= o;
          }
        }
      }
      if (lane == 0) keep_words[cw] = ~cur & (n == kWord ? ~0ull : (1ull << n) - 1ull);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kThreads) {
    keep[s * N + i] = (keep_words[i / kWord] >> (i % kWord)) & 1ull;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for N boxes, and their
// classes when `with_classes`; the wrapper checks it against the card's limit
// before launching.
extern "C" long long tpu3dsis_nms3d_smem(int N, int with_classes) {
  const long long cb = words(N);
  return 32LL * N + (static_cast<long long>(N) + 2) * cb * 8 + (with_classes ? 4LL * N : 0LL);
}

// Kernel launches so far (one per call that had boxes).
extern "C" long long tpu3dsis_nms3d_launches() { return g_launches; }

template <bool kClasses>
static cudaError_t launch(const void* boxes, const void* valid, const void* classes, int B, int N,
                          float thresh, double mid, bool tie_up, void* keep, void* stream) {
  const long long smem = tpu3dsis_nms3d_smem(N, kClasses);
  cudaError_t err = cudaFuncSetAttribute(
      nms3d_kernel<kClasses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms3d_kernel<kClasses><<<B * kCluster, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<const int*>(classes), N, thresh, mid, tie_up, static_cast<bool*>(keep));
  return cudaGetLastError();
}

// boxes: (B, N, 6) float32; valid: (B, N) bool; classes: (B, N) int32 for the
// class-aware mode, or null; keep: (B, N) bool output; N <= 64 * 32.
// Returns the cudaError_t.
extern "C" int tpu3dsis_nms3d(const void* boxes, const void* valid, const void* classes,
                              int B, int N, float thresh, void* keep, void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const float next = nextafterf(thresh, INFINITY);
  const double mid = (static_cast<double>(thresh) + static_cast<double>(next)) * 0.5;
  unsigned next_bits;
  memcpy(&next_bits, &next, sizeof(next_bits));
  const bool tie_up = (next_bits & 1u) == 0u;
  if (words(N) > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      classes ? launch<true>(boxes, valid, classes, B, N, thresh, mid, tie_up, keep, stream)
              : launch<false>(boxes, valid, classes, B, N, thresh, mid, tie_up, keep, stream);
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}
