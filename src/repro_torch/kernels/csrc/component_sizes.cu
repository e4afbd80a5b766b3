// Component sizes for Hopper (sm_90a): `component_sizes` of
// src/repro_torch/app/ops.py, and the size test of its `area_filter` and of
// the `pre` mask of its `watershed_split`.
//
// It replaces no Pallas kernel: the JAX package counts sizes with a plain
// scatter-add (`.at[].add`, src/repro/app/ops.py). It was added because the
// port's plain version on the card, `torch.bincount` over h * w + 1 int64
// bins, did one global atomic a pixel, every background pixel on the one
// extra bin, and read the input's min and max back to the host twice a call:
// at 4096² about 11 ms a call, a third of a pathology item.
//
// What it computes, from int32 labels in which each pixel of a component
// holds the component's root (its least flat index, as label_components
// gives them) and the background holds -1:
//   - count: counts[root] = the pixels that hold `root`;
//   - then, by mode, a pixel's size (sizes: counts[label], 0 on the
//     background) or whether it stays (filter: label >= 0 && lo <= size &&
//     size <= hi, as bytes 0 or 1).
// Labels outside [0, h * w) count as background. Integer sums are exact in
// any order of the atomics, so the result is the plain version's bit for bit.
//
// Design: a cudaMemsetAsync of the h * w int32 counts, then two launches,
// each a thread to four pixels read as 16 bytes. Count: a thread first sums
// the equal labels among its own four pixels (the first pixel of a label
// carries its count); then the warp merges equal labels slot by slot:
// __match_any_sync groups the lanes that hold one label, three ballots of
// the counts' bits sum them, and the group's lowest lane makes one
// atomicAdd. A slot that no lane holds a label in is skipped by the whole
// warp, so the background costs no atomic and a row run of a nucleus one a
// warp (128 pixels), not one a pixel. Look up: each pixel reads its root's
// count; a component's root lies at or above its pixels, so the reads
// mostly hit L2, and a thread reads once for equal neighbours.
//
// What bounds it on this card: bytes. The filter reads the labels twice (4
// bytes a pixel each), zeroes the counts (4) and writes the mask (1): 13
// bytes a pixel, at 4096² 0.218 GB, 0.065 ms at 3.35 TB/s; sizes writes 4
// bytes a pixel in place of 1. Atomic contention is what could keep it from
// that bound, and the warp merge is what keeps it low: a component of a
// whole 4096² tile is the worst case, every warp's one atomic on one word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

constexpr int SIZES = 0;
constexpr int FILTER = 1;

struct Params {
  const int* labels;
  int* counts;      // h * w, zeroed before the count
  void* out;        // sizes: int32; filter: bytes 0 or 1
  long long n;      // h * w
  int lo, hi;       // filter: the sizes that stay, inclusive
  bool vec;         // 16-byte label loads and 4-pixel stores (aligned pointers)
};

// Four labels from flat index i (i % 4 == 0); -1 past the end and for a
// label outside [0, n).
__device__ __forceinline__ void load4(const Params& p, long long i, int lab[4]) {
  if (p.vec && i + 3 < p.n) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p.labels + i));
    lab[0] = v.x;
    lab[1] = v.y;
    lab[2] = v.z;
    lab[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) lab[j] = i + j < p.n ? __ldg(p.labels + i + j) : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lab[j] < 0 || lab[j] >= p.n) lab[j] = -1;
}

__global__ void __launch_bounds__(THREADS) count_kernel(Params p) {
  const long long i = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
  int lab[4];
  load4(p, i, lab);  // threads past the end hold -1 and take part in the warp's merges
  // the thread's own pixels: the first pixel of each label carries the
  // count of that label among the four, the others 0
  int c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool first = lab[j] >= 0;
#pragma unroll
    for (int k = 0; k < j; ++k) first = first && lab[k] != lab[j];
    int n = 0;
#pragma unroll
    for (int k = j; k < 4; ++k) n += lab[k] == lab[j] ? 1 : 0;
    c[j] = first ? n : 0;
  }
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (__ballot_sync(FULL, c[j] > 0) == 0u) continue;  // the whole warp skips the slot
    const int key = c[j] > 0 ? lab[j] : -1;
    const unsigned peers = __match_any_sync(FULL, key);
    const unsigned b0 = __ballot_sync(FULL, c[j] & 1), b1 = __ballot_sync(FULL, c[j] & 2),
                   b2 = __ballot_sync(FULL, c[j] & 4);
    if (c[j] > 0 && lane == (unsigned)(__ffs(peers) - 1))
      atomicAdd(p.counts + key,
                __popc(peers & b0) + 2 * __popc(peers & b1) + 4 * __popc(peers & b2));
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) lookup_kernel(Params p) {
  const long long i = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
  if (i >= p.n) return;
  int lab[4], s[4];
  load4(p, i, lab);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && lab[j] == lab[j - 1])
      s[j] = s[j - 1];
    else
      s[j] = lab[j] >= 0 ? __ldg(p.counts + lab[j]) : 0;
  }
  const bool whole = p.vec && i + 3 < p.n;
  if (MODE == SIZES) {
    int* out = static_cast<int*>(p.out) + i;
    if (whole) {
      *reinterpret_cast<int4*>(out) = make_int4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < p.n) out[j] = s[j];
    }
  } else {
    unsigned char keep[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      keep[j] = lab[j] >= 0 && p.lo <= s[j] && s[j] <= p.hi ? 1 : 0;
    unsigned char* out = static_cast<unsigned char*>(p.out) + i;
    if (whole) {
      *reinterpret_cast<uchar4*>(out) = make_uchar4(keep[0], keep[1], keep[2], keep[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < p.n) out[j] = keep[j];
    }
  }
}

}  // namespace

// One call: `counts` (n int32, any content) is zeroed and filled, then
// `out` (n int32 in mode 0, sizes; n bytes in mode 1, filter) is written.
// `labels`: n int32, each -1 (background) or the flat index of its
// component's root in [0, n). `lo`, `hi`: filter's inclusive bounds on a
// size. `out` and `counts` must alias neither each other nor `labels`.
// Everything is issued on `stream`; nothing waits for the card. Needs
// n < 2^31 - 1. Returns the CUDA error code (0 = ok).
extern "C" int component_sizes(int mode, const int* labels, int* counts, void* out,
                               long long n, int lo, int hi, void* stream) {
  if ((mode != SIZES && mode != FILTER) || n < 0 || n >= 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.labels = labels;
  p.counts = counts;
  p.out = out;
  p.n = n;
  p.lo = lo;
  p.hi = hi;
  p.vec = reinterpret_cast<size_t>(labels) % 16 == 0 &&
          reinterpret_cast<size_t>(out) % (mode == SIZES ? 16 : 4) == 0;
  const long long threads = (n + 3) / 4;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  cudaError_t e = cudaMemsetAsync(counts, 0, n * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  count_kernel<<<grid, THREADS, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (mode == SIZES)
    lookup_kernel<SIZES><<<grid, THREADS, 0, s>>>(p);
  else
    lookup_kernel<FILTER><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
