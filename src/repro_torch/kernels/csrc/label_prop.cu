// Label propagation to a fixpoint for Hopper (sm_90a): the label loops of
// src/repro_torch/app/ops.py, `label_components` and the watershed's
// seeded flood.
//
// It replaces no Pallas kernel: the JAX package runs these loops as plain
// jax.lax.while_loop's over shifted copies (src/repro/app/ops.py). It was
// added because, run step by step from Python, each step of each loop built
// eight padded full-image copies, took eight strided minima and then waited
// for the host to read a flag: at 4096² a conn-8 step moved about 3.4 GB,
// and the card idled on every readback.
//
// What it computes, in one of two modes fixed by the call site, with `big`
// the value of pixels outside the image:
//   - component: lab0 = mask ? flat index : big, then
//     new = mask ? min(lab, its 4 or 8 neighbours) : big; big is 0xffffffff,
//     so the background reads as -1 in int32 at the end, as
//     torch.where(mask, lab, -1) gives it;
//   - flood: lab0 = the seeds, then
//     new = (lab == big && pre) ? min(its neighbours) : lab, big = h * w;
// each until the first step that changes no pixel, as the Python loops do.
// Labels compare as unsigned: flood labels lie in [0, h*w], so the order
// is the signed one.
//
// Design: one persistent kernel a loop, launched with
// cudaLaunchCooperativeKernel so that every block is resident, two steps
// between grid barriers (cooperative_groups::this_grid().sync()). Every
// step is synchronous: it computes each pixel from the labels of the step
// before, so the result and the number of steps are the Python loop's by
// construction. A block takes TH x TW tiles in turn. It copies the tile
// with a two-pixel halo (big outside the image) and the mask of the tile
// and a one-pixel ring into shared memory; the first step takes the tile
// and the ring, whose 3 x 3 neighbourhoods the copy holds, into a second
// shared buffer; the second step takes the tile from there into the other
// buffer in device memory (two buffers in turn, group by group). A thread
// walks one column of a strip of rows with a three-row window in
// registers, so a pixel's neighbours are read from shared memory once a
// row; the ring's two columns take a pixel a thread. A block that changed
// a pixel of its tile ORs the group's steps that did into the group's flag
// (three words, one a group mod 3; block 0 clears the one the group after
// next will use, which no block reads any more); after the barrier every
// block reads it and stops at the first step that changed nothing: the
// group's first step (the labels the last group wrote are the fixpoint),
// or its second (those the group wrote). Group 1 reads the input
// (component: the mask, turned into lab0 while it is copied; flood: the
// seeds) and writes `out`, group g `out` where g is odd and the scratch
// where it is even. A group writes what it read where both its steps
// change nothing, so `out` holds the fixpoint, but for a loop that ends
// at the second step of an even group: then the blocks copy the scratch
// into `out`. The kernel adds its steps to a counter on the card; the host
// never waits for the call.
//
// What bounds it on this card: bytes. A step of the Python loop reads 4
// bytes of labels and 1 of mask a pixel and writes 4: at 4096², 144 MiB,
// 0.045 ms at 3.35 TB/s. Two steps a barrier read and write the labels
// once for both (4.5 bytes a pixel a step; the halo rows and columns are
// a neighbouring tile's and mostly hit L2), at the price of the ring's
// pixels computed twice and a second pass over shared memory. The copy
// reads 16 bytes a thread where the width allows (w % 4 == 0, aligned
// pointers); each warp writes a row of 32 pixels as one 128-byte line;
// label traffic goes through L2 (__ldcg, __stcg): L1 is not coherent
// across SMs within a kernel, and a buffer's labels were written by other
// blocks in the group before. On an H100 this reads 33 us a step at 4096²
// (the area_pre labelling, conn 8), against 57 us with one step a barrier.
//
// The only wait is the grid barrier, which the cooperative launch makes
// safe (a grid larger than the co-resident limit is refused, and the host
// checks the limit first). Every step either changes a pixel, which can
// happen at most h * w times in a row in either mode (component: a label
// only falls; flood: a pixel is labelled once), or ends the loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 32;                     // tile rows
constexpr int TW = 128;                    // tile columns
constexpr int THREADS = 256;               // a block: TW columns x 2 strips
// Four blocks an SM (64 registers a thread, no spill) read 32.7 us a step
// at 4096² on an H100, against 36.4 us with three and 42.4 us with two.
constexpr int BLOCKS_PER_SM = 4;
constexpr int C0 = 4;                      // shared column of the tile's column 0 (16-byte aligned)
constexpr int PITCH = TW + 8;              // label rows: columns C0 - 2 .. C0 + TW + 1 used
constexpr int MC0 = 16;                    // shared byte column of the tile's column 0
constexpr int MPITCH = TW + 32;            // mask rows: columns MC0 - 1 .. MC0 + TW used
constexpr int GPR = TW / 4;                // 16-byte groups a label row
constexpr int ROW_LOADS = TH * GPR / THREADS;
constexpr int RS1 = (TH + 2) / 2;          // rows a thread computes in a group's first step
constexpr int RS2 = TH / 2;                // ... in its second
static_assert(TH * GPR % THREADS == 0 && 4 * GPR + 4 * (TH + 4) / 2 <= THREADS, "loads");
static_assert(TH * TW / 16 == THREADS && 2 * (TH + 2) + 16 <= THREADS, "mask loads");

constexpr int COMPONENT = 0;
constexpr int FLOOD = 1;

struct Params {
  const unsigned char* mask;   // component: the mask; flood: pre
  const uint32_t* seeds;       // flood: the labels to start from
  uint32_t* out;
  uint32_t* tmp;               // the second buffer, h * w
  int* flags;                  // three words: a group's steps that changed a pixel, by group mod 3
  unsigned long long* totals;  // steps, summed over calls
  int h, w, tiles_x, ntiles;
  uint32_t big;
  bool vec;                    // w % 4 == 0 and aligned pointers: 16-byte label loads
  bool vec16;                  // w % 16 == 0 and an aligned mask: 16-byte mask loads
};

struct __align__(16) Tile {
  uint32_t a[TH + 4][PITCH];         // rows y0 - 2 .. y0 + TH + 1 at the group's start
  uint32_t b[TH + 2][PITCH];         // rows y0 - 1 .. y0 + TH after its first step
  unsigned char mk[TH + 2][MPITCH];  // the mask of b's pixels
};

template <int MODE, bool FIRST>
__device__ __forceinline__ uint32_t load1(const Params& p, const uint32_t* src, int y, int x) {
  if (y < 0 || y >= p.h || x < 0 || x >= p.w) return p.big;
  const long long i = (long long)y * p.w + x;
  if (FIRST && MODE == COMPONENT) return __ldg(p.mask + i) ? (uint32_t)i : p.big;
  if (FIRST) return __ldg(p.seeds + i);
  return __ldcg(src + i);
}

// Four labels of a row from column x on (x % 4 == 0).
template <int MODE, bool FIRST>
__device__ __forceinline__ uint4 load4(const Params& p, const uint32_t* src, int y, int x) {
  if (p.vec && y >= 0 && y < p.h && x < p.w) {
    const long long i = (long long)y * p.w + x;
    if (FIRST && MODE == COMPONENT) {
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(p.mask + i));
      const uint32_t k = (uint32_t)i;
      return make_uint4(m.x ? k : p.big, m.y ? k + 1 : p.big, m.z ? k + 2 : p.big,
                        m.w ? k + 3 : p.big);
    }
    if (FIRST) return __ldg(reinterpret_cast<const uint4*>(p.seeds + i));
    return __ldcg(reinterpret_cast<const uint4*>(src + i));
  }
  return make_uint4(load1<MODE, FIRST>(p, src, y, x), load1<MODE, FIRST>(p, src, y, x + 1),
                    load1<MODE, FIRST>(p, src, y, x + 2), load1<MODE, FIRST>(p, src, y, x + 3));
}

// Two labels of a row from column x on (x % 2 == 0).
template <int MODE, bool FIRST>
__device__ __forceinline__ uint2 load2(const Params& p, const uint32_t* src, int y, int x) {
  if (!FIRST && p.vec && y >= 0 && y < p.h && x >= 0 && x < p.w)
    return __ldcg(reinterpret_cast<const uint2*>(src + (long long)y * p.w + x));
  return make_uint2(load1<MODE, FIRST>(p, src, y, x), load1<MODE, FIRST>(p, src, y, x + 1));
}

// 16 mask bytes of row y from column x on (x % 16 == 0), 0 outside.
__device__ __forceinline__ uint4 mask16(const Params& p, int y, int x) {
  if (y < 0 || y >= p.h) return make_uint4(0, 0, 0, 0);
  if (p.vec16 && x < p.w)
    return __ldg(reinterpret_cast<const uint4*>(p.mask + (long long)y * p.w + x));
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (x + j < p.w) b[j / 4] |= (uint32_t)__ldg(p.mask + (long long)y * p.w + x + j) << (8 * (j % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ unsigned char mask1(const Params& p, int y, int x) {
  return y >= 0 && y < p.h && x >= 0 && x < p.w ? __ldg(p.mask + (long long)y * p.w + x) : 0;
}

template <int MODE>
__device__ __forceinline__ uint32_t update(const Params& p, uint32_t old, uint32_t m, bool on) {
  return MODE == COMPONENT ? (on ? m : p.big) : (old == p.big && on ? m : old);
}

// The min over a pixel and its neighbours, rows u (above), v, d (below).
template <int CONN>
__device__ __forceinline__ uint32_t min9(uint32_t u0, uint32_t u1, uint32_t u2, uint32_t v0,
                                         uint32_t v1, uint32_t v2, uint32_t d0, uint32_t d1,
                                         uint32_t d2) {
  uint32_t m = min(min(u1, d1), min(v1, min(v0, v2)));
  if (CONN == 8) m = min(m, min(min(u0, u2), min(d0, d2)));
  return m;
}

// Two steps over tile t: reads `src` (or the input at step 1) with a
// two-pixel halo, takes the tile and a one-pixel ring one step in shared
// memory, the tile a second step into `dst`. Returns the steps in which
// this thread changed a pixel of the tile, as bits.
template <int MODE, int CONN, bool FIRST>
__device__ __forceinline__ unsigned group_tile(const Params& p, Tile& S, int t,
                                               const uint32_t* src, uint32_t* dst) {
  const int y0 = (t / p.tiles_x) * TH, x0 = (t % p.tiles_x) * TW;
  const int tid = threadIdx.x;

  // every load in flight at once: the tile's rows, 16 bytes a load; a halo
  // row's 16 bytes (threads 0-127), or two halo columns' pixels of a row
  // (128 on); the mask of the tile and its ring
  uint4 g[ROW_LOADS];
#pragma unroll
  for (int k = 0; k < ROW_LOADS; ++k) {
    const int i = tid + k * THREADS;
    g[k] = load4<MODE, FIRST>(p, src, y0 + i / GPR, x0 + 4 * (i % GPR));
  }
  uint4 e = make_uint4(0, 0, 0, 0);
  const int hr = tid / GPR;  // 0, 1: rows y0 - 2, y0 - 1; 2, 3: rows y0 + TH, y0 + TH + 1
  const int hy = hr < 2 ? y0 - 2 + hr : y0 + TH - 2 + hr;
  const int sj = tid - 4 * GPR, sr = sj % (TH + 4), sx = sj < TH + 4 ? x0 - 2 : x0 + TW;
  if (tid < 4 * GPR) {
    e = load4<MODE, FIRST>(p, src, hy, x0 + 4 * (tid % GPR));
  } else if (sj < 2 * (TH + 4)) {
    const uint2 v = load2<MODE, FIRST>(p, src, y0 - 2 + sr, sx);
    e.x = v.x;
    e.y = v.y;
  }
  const uint4 mk = mask16(p, y0 + tid / (TW / 16), x0 + 16 * (tid % (TW / 16)));
  uint4 mk2 = make_uint4(0, 0, 0, 0);  // the ring's rows (threads 0-15) and columns (16 on)
  const int mj = tid - 16;
  if (tid < 16) {
    mk2 = mask16(p, tid < 8 ? y0 - 1 : y0 + TH, x0 + 16 * (tid % 8));
  } else if (mj < 2 * (TH + 2)) {
    mk2.x = mask1(p, y0 - 1 + mj % (TH + 2), mj < TH + 2 ? x0 - 1 : x0 + TW);
  }
  __syncthreads();  // the block's last tile is read
#pragma unroll
  for (int k = 0; k < ROW_LOADS; ++k) {
    const int i = tid + k * THREADS;
    *reinterpret_cast<uint4*>(&S.a[2 + i / GPR][C0 + 4 * (i % GPR)]) = g[k];
  }
  if (tid < 4 * GPR) {
    *reinterpret_cast<uint4*>(&S.a[hr < 2 ? hr : TH + hr][C0 + 4 * (tid % GPR)]) = e;
  } else if (sj < 2 * (TH + 4)) {
    S.a[sr][sx - x0 + C0] = e.x;
    S.a[sr][sx - x0 + C0 + 1] = e.y;
  }
  *reinterpret_cast<uint4*>(&S.mk[1 + tid / (TW / 16)][MC0 + 16 * (tid % (TW / 16))]) = mk;
  if (tid < 16) {
    *reinterpret_cast<uint4*>(&S.mk[tid < 8 ? 0 : TH + 1][MC0 + 16 * (tid % 8)]) = mk2;
  } else if (mj < 2 * (TH + 2)) {
    S.mk[mj % (TH + 2)][mj < TH + 2 ? MC0 - 1 : MC0 + TW] = (unsigned char)mk2.x;
  }
  __syncthreads();

  const int c = tid % TW, half = tid / TW;
  unsigned changed = 0;
  {  // first step: b's rows half*RS1 .. +RS1 (image rows y0 - 1 + r) from a
    const int sc = C0 + c, r0 = half * RS1;
    uint32_t u0 = S.a[r0][sc - 1], u1 = S.a[r0][sc], u2 = S.a[r0][sc + 1];
    uint32_t v0 = S.a[r0 + 1][sc - 1], v1 = S.a[r0 + 1][sc], v2 = S.a[r0 + 1][sc + 1];
#pragma unroll 4
    for (int i = 0; i < RS1; ++i) {
      const int r = r0 + i;
      const uint32_t d0 = S.a[r + 2][sc - 1], d1 = S.a[r + 2][sc], d2 = S.a[r + 2][sc + 1];
      const uint32_t nv = update<MODE>(p, v1, min9<CONN>(u0, u1, u2, v0, v1, v2, d0, d1, d2),
                                       S.mk[r][MC0 + c]);
      S.b[r][sc] = nv;
      if (r >= 1 && r <= TH && nv != v1) changed = 1;  // out of the image nothing moves
      u0 = v0; u1 = v1; u2 = v2;
      v0 = d0; v1 = d1; v2 = d2;
    }
    // the ring's two columns, a pixel a thread
    if (tid < 2 * (TH + 2)) {
      const int r = tid % (TH + 2), col = tid < TH + 2 ? C0 - 1 : C0 + TW;
      const uint32_t nv = update<MODE>(
          p, S.a[r + 1][col],
          min9<CONN>(S.a[r][col - 1], S.a[r][col], S.a[r][col + 1], S.a[r + 1][col - 1],
                     S.a[r + 1][col], S.a[r + 1][col + 1], S.a[r + 2][col - 1], S.a[r + 2][col],
                     S.a[r + 2][col + 1]),
          S.mk[r][col - C0 + MC0]);
      S.b[r][col] = nv;
    }
  }
  __syncthreads();
  {  // second step: the tile's rows half*RS2 .. +RS2 from b into dst
    const int sc = C0 + c, r0 = half * RS2, x = x0 + c;
    uint32_t u0 = S.b[r0][sc - 1], u1 = S.b[r0][sc], u2 = S.b[r0][sc + 1];
    uint32_t v0 = S.b[r0 + 1][sc - 1], v1 = S.b[r0 + 1][sc], v2 = S.b[r0 + 1][sc + 1];
    uint32_t* out = dst + (long long)(y0 + r0) * p.w + x;
    const int rows = min(RS2, p.h - (y0 + r0));
#pragma unroll 4
    for (int i = 0; i < RS2; ++i) {
      const uint32_t d0 = S.b[r0 + i + 2][sc - 1], d1 = S.b[r0 + i + 2][sc],
                     d2 = S.b[r0 + i + 2][sc + 1];
      const uint32_t nv = update<MODE>(p, v1, min9<CONN>(u0, u1, u2, v0, v1, v2, d0, d1, d2),
                                       S.mk[r0 + i + 1][MC0 + c]);
      if (i < rows && x < p.w) {
        __stcg(out, nv);
        if (nv != v1) changed |= 2;
      }
      out += p.w;
      u0 = v0; u1 = v1; u2 = v2;
      v0 = d0; v1 = d1; v2 = d2;
    }
  }
  return changed;
}

template <int MODE, int CONN, bool FIRST>
__device__ unsigned group(const Params& p, Tile& S, const uint32_t* src, uint32_t* dst) {
  unsigned changed = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x)
    changed |= group_tile<MODE, CONN, FIRST>(p, S, t, src, dst);
  return changed;
}

template <int MODE, int CONN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) label_prop_kernel(Params p) {
  __shared__ Tile S;
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x < 3) p.flags[threadIdx.x] = 0;
  grid.sync();
  int g = 1, bits = 0;
  for (;; ++g) {
    uint32_t* dst = (g & 1) ? p.out : p.tmp;
    const uint32_t* src = (g & 1) ? p.tmp : p.out;
    const unsigned mine = g == 1 ? group<MODE, CONN, true>(p, S, src, dst)
                                 : group<MODE, CONN, false>(p, S, src, dst);
    const int c1 = __syncthreads_or(mine & 1u), c2 = __syncthreads_or(mine & 2u);
    if (threadIdx.x == 0 && (c1 || c2)) atomicOr(p.flags + g % 3, (c1 ? 1 : 0) | (c2 ? 2 : 0));
    if (blockIdx.x == 0 && threadIdx.x == 0) p.flags[(g + 1) % 3] = 0;
    grid.sync();
    bits = __ldcg(p.flags + g % 3);
    if (bits != 3) break;
  }
  // a group's first step that changed nothing ends the loop there; its
  // second one, after its first changed a pixel, ends it in the buffer the
  // group wrote, which is the scratch in an even group
  if (!(g & 1) && bits == 1) {
    const long long n = (long long)p.h * p.w;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS)
      __stcg(p.out + i, __ldcg(p.tmp + i));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(p.totals, (unsigned long long)(2 * g - (bits & 1 ? 0 : 1)));
}

const void* kernel_for(int mode, int conn) {
  if (mode == COMPONENT)
    return conn == 4 ? (const void*)label_prop_kernel<COMPONENT, 4>
                     : (const void*)label_prop_kernel<COMPONENT, 8>;
  return conn == 4 ? (const void*)label_prop_kernel<FLOOD, 4>
                   : (const void*)label_prop_kernel<FLOOD, 8>;
}

}  // namespace

// The tile (rows, columns) and the threads a block.
extern "C" void label_prop_tile(int* th, int* tw, int* threads) {
  *th = TH;
  *tw = TW;
  *threads = THREADS;
}

// The most blocks of `mode` (0 component, 1 flood) and `conn` that can be
// resident at once on the current device.
extern "C" int label_prop_max_blocks(int mode, int conn, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  *blocks = 0;
  if ((mode != COMPONENT && mode != FLOOD) || (conn != 4 && conn != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(mode, conn), THREADS, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// One loop to its fixpoint: `out` (h x w int32) gets the labels. `mask`:
// h x w bytes, 0 or 1 (component: the mask; flood: pre). `seeds`: flood's
// starting labels (h x w int32, each in [0, h*w]); unused by component.
// `scratch`: h * w + 4 int32, any content; `out` must alias none of the
// inputs. The kernel adds its steps to `totals` (one int64 on the card).
// `grid_blocks`: at most label_prop_max_blocks' count (a larger grid is
// refused by the cooperative launch). Needs h * w < 2^31 - 1. Returns the
// CUDA error code (0 = ok).
extern "C" int label_prop(int mode, const unsigned char* mask, const int* seeds, int* out,
                          int* scratch, unsigned long long* totals, int h, int w, int conn,
                          int grid_blocks, void* stream) {
  if ((mode != COMPONENT && mode != FLOOD) || (conn != 4 && conn != 8) || h <= 0 || w <= 0 ||
      (long long)h * w >= 2147483647LL || grid_blocks <= 0 || (mode == FLOOD && !seeds))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.mask = mask;
  p.seeds = reinterpret_cast<const uint32_t*>(seeds);
  p.out = reinterpret_cast<uint32_t*>(out);
  p.tmp = reinterpret_cast<uint32_t*>(scratch);
  p.flags = scratch + (long long)h * w;
  p.totals = totals;
  p.h = h;
  p.w = w;
  p.tiles_x = (w + TW - 1) / TW;
  p.ntiles = p.tiles_x * ((h + TH - 1) / TH);
  p.big = mode == COMPONENT ? 0xffffffffu : (uint32_t)((long long)h * w);
  p.vec16 = w % 16 == 0 && reinterpret_cast<size_t>(mask) % 16 == 0;
  p.vec = w % 4 == 0 && reinterpret_cast<size_t>(mask) % 4 == 0 &&
          reinterpret_cast<size_t>(out) % 16 == 0 && reinterpret_cast<size_t>(scratch) % 16 == 0 &&
          (mode == COMPONENT || reinterpret_cast<size_t>(seeds) % 16 == 0);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel_for(mode, conn), dim3(grid_blocks),
                                              dim3(THREADS), args, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
