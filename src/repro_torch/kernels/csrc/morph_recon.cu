// Grayscale morphological reconstruction by dilation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/morph_recon.py:
// `_recon_sweep_kernel`, its launcher `tile_sweep` and the fixpoint loop
// `morph_reconstruct_pallas`.
//
// What it computes: m = min(marker, mask), then m <- min(max over m and its
// 4 or 8 neighbours, mask) until nothing changes. Neighbours outside the
// image are -INFINITY.
//
// Design: one persistent kernel a call, launched with
// cudaLaunchCooperativeKernel so that every block is resident, runs rounds
// over a worklist of TH x TW tiles, the rounds separated by
// cooperative_groups::this_grid().sync(). Round 1 visits every tile; a tile
// is visited in round k+1 only if it or a neighbour asked for it in round k
// (below). The call ends when a round's worklist is empty. The kernel adds
// its rounds and tile visits to two counters on the card; the host does
// not wait for the call.
//
// A visit belongs to one warp, which pulls tile indices from the round's
// worklist (atomicAdd on the round's head). It copies the tile, a one-pixel
// halo and their mask into its own shared memory with cp.async (round 1:
// min(marker, mask); later rounds: m, through L2 only, since L1 is not
// coherent across SMs within a kernel) and alternates raster and
// anti-raster passes (Vincent 1993) until a pass after the first changes
// nothing, or `max_passes` have run. The raster pass walks the rows
// top-down: each pixel first takes the max over itself and the new row
// above (conn 8: three pixels, conn 4: one), then the row runs v[x] =
// min(max(v[x], v[x-1]), mask[x]) from its left halo pixel. That recurrence
// is an inclusive scan over the clamp functions u -> min(max(u, a), b),
// which are closed under composition: (a1, b1) then (a2, b2) is
// (max(a1, a2), min(max(b1, a2), b2)). A lane composes its K = TW/32 pixels
// in order, the warp scans the lanes' compositions with 5 __shfl_up_sync
// steps, and each lane applies the prefix before it to its pixels. The
// anti-raster pass is the mirror image (rows bottom-up, the row below,
// right to left, __shfl_down_sync). A pass runs only the rows whose inputs
// changed since its direction last left the tile stable, and the rows
// after them that change (see `pass`).
//
// A visit writes back the rows it changed (round 1: all) and then tells
// each neighbour which of its halo pixels moved, in a 64-bit word a tile
// and round (atomicOr; the first one queues the tile with atomicAdd on the
// next round's count, so a tile is queued at most once a round):
//   - the tile itself, "every row", if its last pass still changed
//     something (the cap was hit);
//   - the tile above, if a pixel q of row 0 moved that can raise a pixel p
//     of its row below next to q: min(q, mask[p]) > p, with p as this visit
//     read it (p only rises, so the test can only wake too often); the same
//     for the tile below; the tile to the left gets the rows of column 0
//     whose pixel can raise one of its column TW-1, and so on; with conn 8
//     the diagonal neighbours for the corner pixels.
// The woken tile starts each direction's first pass with the rows that read
// those pixels: a raster pass reads the left column (each row's carry), the
// row above (row 0) and, with conn 8, the side columns one row up.
//
// Why the worklist gives the global fixpoint. A raster pass is idempotent
// for a fixed halo: by induction in raster order, a second pass reads the
// same values before every pixel and max/min of a value with the same
// operands again change nothing. So a row whose inputs (its own pixels, the
// row before it in pass order, its halo pixels) have not changed since its
// direction last left it stable stays as it is, which is why a pass may
// skip it; and a visit that stops because a pass after the first changed
// nothing leaves its tile stable under both passes for the halo it read,
// i.e. every pixel equals min(max over itself and its neighbours, mask).
// Claim: after round k, every tile not queued for round k+1 is stable for
// the current m. A tile visited in round k ended stable for the halo it
// read, or queued itself. Its halo pixels belong to its neighbours and
// change only in their visits; a round-k visit that moved one of them in a
// way that can raise one of the tile's pixels queued it, naming the pixel,
// and a move that cannot raise any leaves the tile stable. So if it is not
// queued, it is stable for the halo as it is now (a neighbour's earlier
// writes are visible after the grid barrier; in round 1 the halo is read
// from min(marker, mask), which is m before any visit). A tile not visited
// in round k was stable after round k-1 (induction; round 1 visits every
// tile) and neither its pixels nor, unqueued, its halo moved in a way that
// matters. So an empty worklist means m is a fixpoint of the update
// everywhere. Every update is monotone and stays below the reconstruction
// r (r is a fixpoint of the same update; a halo read while a neighbour
// writes it returns the old or the new value, both in [m0, r]), so m is a
// fixpoint in [marker, r], hence m = r. The schedule (which warp reads
// which halo value when) changes the rounds and visits, never the result;
// only fmaxf and fminf touch the values, so it is exact to the bit.
//
// What bounds it on this card: the bytes (marker and mask read, m written:
// 12 bytes a pixel) are 0.06 ms at 4096²; the passes are the work. A row
// of a pass is a dependent chain of 11 to 13 shuffles and about 20 min/max (fp32
// min/max issue at half the rate of an add), and a warp holds one tile, so
// what is in flight on an SM is one chain for each tile its shared memory
// holds: 12, at 18,720 bytes a tile. Information crosses a tile edge once a
// round (or sooner, when a neighbour's visit has already written), so the
// rounds grow with the longest geodesic path over the tile size: tiles are
// wide (TW = 128, four pixels a lane) and short (TH = 16 keeps a visit's
// chain short). The pass cap (the wrapper's MAX_PASSES) trades passes a
// visit against rounds; a capped tile continues next round.
//
// The kernel has no spin wait of its own: the only wait is the grid
// barrier, which the cooperative launch makes safe (a grid larger than the
// co-resident limit is refused, and the host checks the limit first).
//
// NaN is outside the contract: fmaxf/fminf drop a NaN operand, where
// torch.maximum propagates it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;
constexpr int TW = 128;
constexpr int K = TW / 32;  // pixels a lane, consecutive in the row
constexpr int WARPS = 4;    // a block's warps; each visits tiles on its own
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ROWS = (1u << TH) - 1;
static_assert(K == 4 && TH <= 16, "a lane holds one float4 of a row; a row is a bit of 16");

// What changed in a tile's halo, as its neighbours report it (one 64-bit
// word a tile and round): bit r (r < 16) row r of the left halo column, bit
// 16 + r row r of the right one; then the halo row above, the row below, a
// corner above, a corner below, and "every row" (round 1, or a visit that
// hit the pass cap).
constexpr unsigned long long F_ABOVE = 1ull << 32, F_BELOW = 1ull << 33;
constexpr unsigned long long F_CORNER_ABOVE = 1ull << 34, F_CORNER_BELOW = 1ull << 35;
constexpr unsigned long long F_ALL = 1ull << 36;

// scratch layout (int32): counts[3], heads[3], pad[2], queue[2][ntiles],
// pad to 8 bytes, flags[2][ntiles] (int64)
constexpr int CNT = 0, HEAD = 3, QUEUE = 8;

__host__ __device__ inline long long flags_offset(int ntiles) {
  return (QUEUE + 2LL * ntiles + 1) / 2 * 2;
}

struct alignas(16) WarpTile {
  float v[TH][TW];
  float mk[TH][TW];
  float top[TW];     // the halo row above
  float bot[TW];     // the halo row below
  float left[TH];    // column -1 of each row
  float right[TH];   // column TW of each row
  float corner[4];   // above-left, above-right, below-left, below-right
  float hmk[2][TW];  // the mask of the halo rows above and below
  float lmk[TH];     // ... of the halo columns
  float rmk[TH];
  float cmk[4];      // ... of the corners
};

struct Params {
  const float* marker;
  const float* mask;
  float* m;
  int* scratch;
  unsigned long long* totals;  // rounds and tile visits, summed over calls
  int h, w, tiles_x, ntiles, max_passes;
  bool vec;  // w % 4 == 0: whole float4 loads and stores
};

__device__ __forceinline__ unsigned long long* flags(const Params& p, int k) {
  return reinterpret_cast<unsigned long long*>(p.scratch + flags_offset(p.ntiles)) +
         (k % 2) * p.ntiles;
}

__device__ __forceinline__ float4 neg_inf4() {
  return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
}

__device__ __forceinline__ float4 row4(const float* row, int lane) {
  return *reinterpret_cast<const float4*>(row + lane * K);
}

// K = 4 values of a row from column x on; columns >= w read as -inf.
// CG: through L2 (m, which other SMs write); else the read-only path.
template <bool CG>
__device__ __forceinline__ float4 load4(const float* row, int x, int w, bool vec) {
  if (vec && x + 3 < w) {
    const float4* p = reinterpret_cast<const float4*>(row + x);
    return CG ? __ldcg(p) : __ldg(p);
  }
  float4 r = neg_inf4();
  float* e = &r.x;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < w) e[j] = CG ? __ldcg(row + x + j) : __ldg(row + x + j);
  return r;
}

__device__ __forceinline__ void store4(float* row, int x, int w, bool vec, float4 v) {
  if (vec && x + 3 < w) {
    __stcg(reinterpret_cast<float4*>(row + x), v);
    return;
  }
  const float* e = &v.x;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < w) __stcg(row + x + j, e[j]);
}

// 16 bytes from global to shared memory, through L2 only (cp.async.cg), and
// the wait for this thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One pixel of the state at the start of round k: round 1 reads
// min(marker, mask), later rounds m. Outside the image: -inf.
__device__ __forceinline__ float load1(const Params& p, bool first, int y, int x) {
  if (y < 0 || y >= p.h || x < 0 || x >= p.w) return -INFINITY;
  const long long i = (long long)y * p.w + x;
  return first ? fminf(__ldg(p.marker + i), __ldg(p.mask + i)) : __ldcg(p.m + i);
}

// The mask at one pixel; outside the image: -inf.
__device__ __forceinline__ float mask1(const Params& p, int y, int x) {
  if (y < 0 || y >= p.h || x < 0 || x >= p.w) return -INFINITY;
  return __ldg(p.mask + (long long)y * p.w + x);
}

// The K pixels of lane `lane` in row y (image coordinates), columns x0 +
// lane*K on, at round k's start state.
__device__ __forceinline__ float4 load_row4(const Params& p, bool first, int y, int x) {
  if (y < 0 || y >= p.h) return neg_inf4();
  const long long off = (long long)y * p.w;
  if (!first) return load4<true>(p.m + off, x, p.w, p.vec);
  const float4 a = load4<false>(p.marker + off, x, p.w, p.vec);
  const float4 b = load4<false>(p.mask + off, x, p.w, p.vec);
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z), fminf(a.w, b.w));
}

// One raster (FWD) or anti-raster pass over the warp's tile. `dirty`: bit r
// set if an input of row r changed since this direction last left the tile
// stable (every row if it never did). A row that is not dirty, and whose
// row before (in pass order) is not dirty and has not changed in this pass,
// has the inputs it had then: a pass is idempotent, so the row is skipped.
// Returns the rows this pass changed, as bits.
template <int CONN, bool FWD>
__device__ __forceinline__ unsigned pass(WarpTile& S, int lane, unsigned dirty) {
  const float4 h4 = row4(FWD ? S.top : S.bot, lane);
  float prev[K] = {h4.x, h4.y, h4.z, h4.w};  // the row before, new values
  float prev_l = S.corner[FWD ? 0 : 2], prev_r = S.corner[FWD ? 1 : 3];  // its columns -1, TW
  constexpr int STEP = FWD ? 1 : -1;
  int r = FWD ? 0 : TH - 1;
  float4 v4 = row4(S.v[r], lane), m4 = row4(S.mk[r], lane);
  float hl = S.left[r], hr = S.right[r];
  unsigned moved = 0;
#pragma unroll 1
  for (int i = 0; i < TH; ++i, r += STEP) {
    // the next row's inputs, read before this row's chain
    const int rn = i + 1 < TH ? r + STEP : r;
    const float4 v4n = row4(S.v[rn], lane), m4n = row4(S.mk[rn], lane);
    const float hln = S.left[rn], hrn = S.right[rn];
    if (((dirty >> r) & 1u) || (i > 0 && (((dirty | moved) >> (r - STEP)) & 1u))) {
      const float old[K] = {v4.x, v4.y, v4.z, v4.w};
      const float mk[K] = {m4.x, m4.y, m4.z, m4.w};
      float u[K];
      if (CONN == 8) {
        float lo = __shfl_up_sync(FULL, prev[K - 1], 1);
        float hi = __shfl_down_sync(FULL, prev[0], 1);
        if (lane == 0) lo = prev_l;
        if (lane == 31) hi = prev_r;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float a = j == 0 ? lo : prev[j - 1];
          const float c = j == K - 1 ? hi : prev[j + 1];
          u[j] = fmaxf(fmaxf(old[j], prev[j]), fmaxf(a, c));
        }
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) u[j] = fmaxf(old[j], prev[j]);
      }
      // prefix compositions within the lane, in scan order
      float pa[K], pb[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int j = FWD ? s : K - 1 - s;
        if (s == 0) {
          pa[j] = u[j];
          pb[j] = mk[j];
        } else {
          const int q = j - STEP;
          pa[j] = fmaxf(pa[q], u[j]);
          pb[j] = fminf(fmaxf(pb[q], u[j]), mk[j]);
        }
      }
      // the lanes' compositions, scanned across the warp. A lane whose
      // source is out of range gets its own pair back, and a clamp composed
      // with itself is itself, so no lane needs a test.
      float a = FWD ? pa[K - 1] : pa[0];
      float b = FWD ? pb[K - 1] : pb[0];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float ea = FWD ? __shfl_up_sync(FULL, a, d) : __shfl_down_sync(FULL, a, d);
        const float eb = FWD ? __shfl_up_sync(FULL, b, d) : __shfl_down_sync(FULL, b, d);
        b = fminf(fmaxf(eb, a), b);
        a = fmaxf(ea, a);
      }
      // the value after this lane's pixels, from the row's carry; the lane
      // before hands it on
      const float carry = FWD ? hl : hr;
      const float out = fminf(fmaxf(carry, a), b);
      const float cin_n = FWD ? __shfl_up_sync(FULL, out, 1) : __shfl_down_sync(FULL, out, 1);
      const float cin = (FWD ? lane == 0 : lane == 31) ? carry : cin_n;
      bool changed = false;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        prev[j] = fminf(fmaxf(cin, pa[j]), pb[j]);
        changed |= prev[j] != old[j];
      }
      *reinterpret_cast<float4*>(&S.v[r][lane * K]) = make_float4(prev[0], prev[1], prev[2], prev[3]);
      if (__any_sync(FULL, changed)) moved |= 1u << r;
    } else {  // the row stays; it is the next row's row before
      prev[0] = v4.x;
      prev[1] = v4.y;
      prev[2] = v4.z;
      prev[3] = v4.w;
    }
    prev_l = hl;
    prev_r = hr;
    v4 = v4n;
    m4 = m4n;
    hl = hln;
    hr = hrn;
  }
  return moved;
}

// Lanes with `bits` tell tile t what changed in its halo in round k; the
// tiles not queued yet for round k+1 are queued, with one atomicAdd a warp.
__device__ __forceinline__ void wake(const Params& p, int t, int k, unsigned long long bits,
                                     int lane) {
  const bool fresh = bits && atomicOr(flags(p, k + 1) + t, bits) == 0;
  const unsigned who = __ballot_sync(FULL, fresh);
  if (!who) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(&p.scratch[CNT + (k + 1) % 3], __popc(who));
  base = __shfl_sync(FULL, base, 0);
  if (fresh) p.scratch[QUEUE + ((k + 1) % 2) * p.ntiles + base + __popc(who & ((1u << lane) - 1))] = t;
}

template <int CONN>
__device__ void visit(const Params& p, WarpTile& S, int t, int k, int lane) {
  const bool first = k == 1;
  const int ty = t / p.tiles_x, tx = t % p.tiles_x;
  const int y0 = ty * TH, x0 = tx * TW, xl = x0 + lane * K;
  __syncwarp();  // the warp's last visit has read its tile

  // what changed in the halo since the tile's last visit; lane 0 fetches
  // it while the tile's rows are on their way
  unsigned long long f = F_ALL;
  if (!first && lane == 0) f = atomicExch(flags(p, k) + t, 0ull);
  // the halo's single pixels, in registers while the rows are copied
  const float corner = lane < 4
      ? load1(p, first, lane < 2 ? y0 - 1 : y0 + TH, lane % 2 ? x0 + TW : x0 - 1) : 0.f;
  const float hl = lane < TH ? load1(p, first, y0 + lane, x0 - 1) : 0.f;
  const float hr = lane < TH ? load1(p, first, y0 + lane, x0 + TW) : 0.f;
  const float cmk = lane < 4
      ? mask1(p, lane < 2 ? y0 - 1 : y0 + TH, lane % 2 ? x0 + TW : x0 - 1) : 0.f;
  const float lmk = lane < TH ? mask1(p, y0 + lane, x0 - 1) : 0.f;
  const float rmk = lane < TH ? mask1(p, y0 + lane, x0 + TW) : 0.f;
  if (p.vec) {
    // every row's four pixels of this lane in flight at once; a float4 lies
    // wholly inside or wholly outside the image (w % 4 == 0)
    const float* src = first ? p.marker : p.m;
    const bool in_x = xl < p.w;
#pragma unroll
    for (int r = -1; r <= TH; ++r) {
      const int y = y0 + r;
      float* dv = r < 0 ? &S.top[lane * K] : r == TH ? &S.bot[lane * K] : &S.v[r][lane * K];
      float* dm = r < 0 ? &S.hmk[0][lane * K] : r == TH ? &S.hmk[1][lane * K] : &S.mk[r][lane * K];
      if (in_x && y >= 0 && y < p.h) {
        const long long off = (long long)y * p.w + xl;
        cp_async16(dv, src + off);
        cp_async16(dm, p.mask + off);
      } else {
        *reinterpret_cast<float4*>(dv) = neg_inf4();
        *reinterpret_cast<float4*>(dm) = neg_inf4();
      }
    }
    cp_async_wait_all();
    if (first) {  // round 1 starts from min(marker, mask)
#pragma unroll
      for (int r = -1; r <= TH; ++r) {
        float* dv = r < 0 ? &S.top[lane * K] : r == TH ? &S.bot[lane * K] : &S.v[r][lane * K];
        const float* dm = r < 0 ? &S.hmk[0][lane * K] : r == TH ? &S.hmk[1][lane * K]
                                : &S.mk[r][lane * K];
#pragma unroll
        for (int j = 0; j < K; ++j) dv[j] = fminf(dv[j], dm[j]);
      }
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < TH; ++r) {
      *reinterpret_cast<float4*>(&S.v[r][lane * K]) = load_row4(p, first, y0 + r, xl);
      const float4 mk = y0 + r < p.h
          ? load4<false>(p.mask + (long long)(y0 + r) * p.w, xl, p.w, false) : neg_inf4();
      *reinterpret_cast<float4*>(&S.mk[r][lane * K]) = mk;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = h ? y0 + TH : y0 - 1;
      *reinterpret_cast<float4*>(h ? &S.bot[lane * K] : &S.top[lane * K]) =
          load_row4(p, first, y, xl);
      *reinterpret_cast<float4*>(&S.hmk[h][lane * K]) =
          y >= 0 && y < p.h ? load4<false>(p.mask + (long long)y * p.w, xl, p.w, false)
                            : neg_inf4();
    }
  }
  f = __shfl_sync(FULL, f, 0);
  if (lane < 4) {
    S.corner[lane] = corner;
    S.cmk[lane] = cmk;
  }
  if (lane < TH) {
    S.left[lane] = hl;
    S.right[lane] = hr;
    S.lmk[lane] = lmk;
    S.rmk[lane] = rmk;
  }
  __syncwarp();

  // the border at the visit's start, to tell the neighbours what changed
  const float4 row0 = row4(S.v[0], lane), rowN = row4(S.v[TH - 1], lane);
  const float col0 = lane < TH ? S.v[lane][0] : 0.f;
  const float colN = lane < TH ? S.v[lane][TW - 1] : 0.f;

  // rows whose inputs changed since the last raster / anti-raster pass: a
  // raster pass reads the left column (each row's carry), the row above (row
  // 0) and, with conn 8, the side columns one row up; an anti-raster pass
  // the mirror image
  unsigned dirty_fwd = ROWS, dirty_bwd = ROWS;
  if (!(f & F_ALL)) {
    const unsigned lr = (unsigned)f & ROWS, rr = (unsigned)(f >> 16) & ROWS;
    dirty_fwd = lr | ((f & (F_ABOVE | F_CORNER_ABOVE)) ? 1u : 0u);
    dirty_bwd = rr | ((f & (F_BELOW | F_CORNER_BELOW)) ? 1u << (TH - 1) : 0u);
    if (CONN == 8) {
      dirty_fwd |= ((lr | rr) << 1) & ROWS;
      dirty_bwd |= (lr | rr) >> 1;
    }
  }
  unsigned touched = 0;
  bool settled = false;
  for (int n = 0; n < p.max_passes; ++n) {
    unsigned rows;
    if (n & 1) {
      rows = pass<CONN, false>(S, lane, dirty_bwd);
      dirty_fwd = rows;
    } else {
      rows = pass<CONN, true>(S, lane, dirty_fwd);
      dirty_bwd = n == 0 ? dirty_bwd | rows : rows;
    }
    touched |= rows;
    if (n > 0 && rows == 0) {
      settled = true;
      break;
    }
  }
  __syncwarp();

  for (int r = 0; r < TH && y0 + r < p.h; ++r)
    if (first || ((touched >> r) & 1u))
      store4(p.m + (long long)(y0 + r) * p.w, xl, p.w, p.vec, row4(S.v[r], lane));
  if (!touched) return;  // nothing moved and the tile is settled

  // A neighbour is told only of a moved border pixel q that can raise a
  // pixel p of its own next to q: min(q, mask[p]) > p, with p as this visit
  // read it (never above p's current value, so the test can only wake too
  // often).
  const float4 n04 = row4(S.v[0], lane), nN4 = row4(S.v[TH - 1], lane);
  const float n0[K] = {n04.x, n04.y, n04.z, n04.w}, s0[K] = {row0.x, row0.y, row0.z, row0.w};
  const float nN[K] = {nN4.x, nN4.y, nN4.z, nN4.w}, sN[K] = {rowN.x, rowN.y, rowN.z, rowN.w};
  bool lift_up = false, lift_down = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int d = CONN == 8 ? -1 : 0; d <= (CONN == 8 ? 1 : 0); ++d) {
      const int x = lane * K + j + d;
      if (x < 0 || x >= TW) continue;
      lift_up |= n0[j] != s0[j] && fminf(n0[j], S.hmk[0][x]) > S.top[x];
      lift_down |= nN[j] != sN[j] && fminf(nN[j], S.hmk[1][x]) > S.bot[x];
    }
  }
  const bool up = __any_sync(FULL, lift_up), down = __any_sync(FULL, lift_down);
  bool lift_l = false, lift_r = false;
  if (lane < TH) {
    const float ql = S.v[lane][0], qr = S.v[lane][TW - 1];
#pragma unroll
    for (int d = CONN == 8 ? -1 : 0; d <= (CONN == 8 ? 1 : 0); ++d) {
      const int y = lane + d;
      if (y < 0 || y >= TH) continue;
      lift_l |= ql != col0 && fminf(ql, S.lmk[y]) > S.left[y];
      lift_r |= qr != colN && fminf(qr, S.rmk[y]) > S.right[y];
    }
  }
  const unsigned col_l = __ballot_sync(FULL, lift_l) & ROWS;
  const unsigned col_r = __ballot_sync(FULL, lift_r) & ROWS;
  // the corner pixels, bits above-left, above-right, below-left,
  // below-right: column 0 is lane 0's first pixel, column TW-1 lane 31's last
  const bool c_first = lane == 0, c_last = lane == 31;
  const unsigned corners =
      (__ballot_sync(FULL, c_first && n0[0] != s0[0] && fminf(n0[0], S.cmk[0]) > S.corner[0]) & 1u) |
      (__ballot_sync(FULL, c_last && n0[K - 1] != s0[K - 1] &&
                               fminf(n0[K - 1], S.cmk[1]) > S.corner[1]) >> 31) << 1 |
      (__ballot_sync(FULL, c_first && nN[0] != sN[0] && fminf(nN[0], S.cmk[2]) > S.corner[2]) & 1u) << 2 |
      (__ballot_sync(FULL, c_last && nN[K - 1] != sN[K - 1] &&
                               fminf(nN[K - 1], S.cmk[3]) > S.corner[3]) >> 31) << 3;
  // lane i tells neighbour (dy, dx) = (i / 3 - 1, i % 3 - 1); lane 4 is the tile itself
  unsigned long long bits = 0;
  int nt = 0;
  if (lane < 9) {
    const int dy = lane / 3 - 1, dx = lane % 3 - 1;
    if (dy == 0 && dx == 0) bits = settled ? 0 : F_ALL;
    else if (dx == 0) bits = dy < 0 ? (up ? F_BELOW : 0) : (down ? F_ABOVE : 0);
    else if (dy == 0) bits = dx < 0 ? (unsigned long long)col_l << 16 : col_r;
    else if (CONN == 8 && ((corners >> ((dy < 0 ? 0 : 2) + (dx < 0 ? 0 : 1))) & 1u))
      bits = dy < 0 ? F_CORNER_BELOW : F_CORNER_ABOVE;
    const int ny = ty + dy, nx = tx + dx;
    nt = ny * p.tiles_x + nx;
    if (ny < 0 || nx < 0 || nx >= p.tiles_x || nt >= p.ntiles) bits = 0;
  }
  wake(p, nt, k, bits, lane);
}

template <int CONN>
__global__ void __launch_bounds__(WARPS * 32) recon_kernel(Params p) {
  extern __shared__ float4 smem[];
  WarpTile& S = reinterpret_cast<WarpTile*>(smem)[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  cg::grid_group grid = cg::this_grid();
  int* s = p.scratch;
  unsigned long long visits = 0;
  int k = 1;
  for (;; ++k) {
    const int count = k == 1 ? p.ntiles : __ldcg(&s[CNT + k % 3]);
    if (count == 0) break;
    visits += count;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the count and head of round k-1, free now, become round k+2's
      s[CNT + (k + 2) % 3] = 0;
      s[HEAD + (k + 2) % 3] = 0;
    }
    for (;;) {
      int i = 0;
      if (lane == 0) i = atomicAdd(&s[HEAD + k % 3], 1);
      i = __shfl_sync(FULL, i, 0);
      if (i >= count) break;
      const int t = k == 1 ? i : __ldcg(&s[QUEUE + (k % 2) * p.ntiles + i]);
      visit<CONN>(p, S, t, k, lane);
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(&p.totals[0], (unsigned long long)(k - 1));
    atomicAdd(&p.totals[1], visits);
  }
}

template <int CONN>
cudaError_t prepare(int* blocks_per_sm) {
  const size_t smem = WARPS * sizeof(WarpTile);
  cudaError_t err = cudaFuncSetAttribute(recon_kernel<CONN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, recon_kernel<CONN>,
                                                       WARPS * 32, smem);
}

}  // namespace

// The tile (rows, columns), its warps a block, and the int32 scratch a call
// needs for h x w.
extern "C" void morph_recon_tile(int* th, int* tw, int* warps) {
  *th = TH;
  *tw = TW;
  *warps = WARPS;
}

extern "C" long long morph_recon_scratch_ints(int h, int w) {
  const long long ntiles = (long long)((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  return flags_offset((int)ntiles) + 4 * ntiles;
}

// The most blocks that can be resident at once on the current device for
// `conn`, and the shared memory a block takes. Sets the kernel's shared
// memory attribute: call it once before the first morph_recon of `conn`.
extern "C" int morph_recon_max_blocks(int conn, int* blocks, int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = conn == 4 ? prepare<4>(&per_sm) : prepare<8>(&per_sm);
  *blocks = per_sm * sms;
  *smem_bytes = (int)(WARPS * sizeof(WarpTile));
  return static_cast<int>(err);
}

// One call: `out` = the reconstruction of `marker` under `mask` (h x w,
// fp32, row-major; out must not alias either), with `grid_blocks` blocks,
// at most morph_recon_max_blocks' count (a larger grid is refused by the
// cooperative launch: cudaErrorCooperativeLaunchTooLarge). `scratch`: the
// int32s of morph_recon_scratch_ints, zero on entry. The kernel adds its
// rounds and tile visits to `totals` (two int64 on the card). Returns the
// CUDA error code (0 = ok).
extern "C" int morph_recon(const float* marker, const float* mask, float* out, int* scratch,
                           unsigned long long* totals, int h, int w, int conn, int max_passes,
                           int grid_blocks, void* stream) {
  if ((conn != 4 && conn != 8) || h <= 0 || w <= 0 || max_passes < 2 || grid_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.marker = marker;
  p.mask = mask;
  p.m = out;
  p.scratch = scratch;
  p.totals = totals;
  p.h = h;
  p.w = w;
  p.tiles_x = (w + TW - 1) / TW;
  p.ntiles = p.tiles_x * ((h + TH - 1) / TH);
  p.max_passes = max_passes;
  p.vec = w % 4 == 0 && reinterpret_cast<size_t>(marker) % 16 == 0 &&
          reinterpret_cast<size_t>(mask) % 16 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      conn == 4 ? (const void*)recon_kernel<4> : (const void*)recon_kernel<8>, dim3(grid_blocks),
      dim3(WARPS * 32), args, WARPS * sizeof(WarpTile), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
