// Causal, sliding-window, prefix-LM, grouped-query attention forward pass on
// Hopper's tensor cores (sm_90a): bf16 q, k, v with a head dim D that is a
// multiple of 16 and at most 256 (gemma3's and PaliGemma's 256 included).
// fp32 inputs, whose 2e-5 bar only fp32 products meet, and bf16 with a head
// dim that is no multiple of 16 take the CUDA-core kernel of
// flash_attention.cu (the wrapper's dispatch).
//
// Replaces, with flash_attention.cu, the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py: `_fa_kernel` and its wrapper
// `flash_attention_pallas`.
//
// What it computes, for q (B,Sq,H,D) and k, v (B,Sk,KV,D), all bf16, with
// query head h reading kv head h / (H/KV), qpos_i = i + q_offset:
//   s[i,j] = (q_i · k_j) in fp32 from exact bf16 products, times scale;
//   kept where j < Sk; j <= qpos_i or j < prefix_len when causal (the
//   prefix-LM mask: every query sees PaliGemma's image prefix); and
//   j > qpos_i − window with a window; a masked logit adds exactly 0 (a row
//   with no key comes out 0);
//   p = exp(s − m) with the fp32 running max m; l = Σ p in fp32;
//   out_i = Σ_j bf16(p_ij) v_j / max(l_i, 1e-30), in fp32, written in bf16.
// This is the JAX model's arithmetic (repro.models.attention.blocked_attention:
// bf16 operands, fp32 sums, probabilities rounded to bf16 before P·V) with
// the scale applied to the fp32 logits rather than to q;
// kernels/ref.flash_attention_blocked repeats it for bf16 inputs.
//
// Design (FlashAttention-3's forward pass: its pipelining inside a
// warpgroup and its ping-pong between warpgroups). One CTA of three
// warpgroups covers 128 query rows of one (batch, head), the longest causal
// rows launched first. Warpgroups 0 and 1 each own 64 rows; one thread of
// warpgroup 2 is the producer: it loads q once, then keeps TMA loads of the
// K and V tiles in flight through rings in shared memory, K and V each with
// their own full/empty mbarriers, so that a K tile's stage is refilled as
// soon as S of its tile has landed, a round before its V tile's (with one
// barrier for both, two stages left a load no round of slack). A key tile
// is 128 keys up to D = 128 (three stages up to D = 112, two at 128) and 64
// keys above (two stages), so that D = 256 fits: q 65,536 bytes, the rings
// 2 × 65,536, 197,704 bytes in all with the barriers and the alignment
// slack (a 128-key ring would need 328,776 of the 232,448 a block may
// have; 80-key tiles would fit in 230,472 bytes and were not found faster
// at gemma3's shapes, so 64 stays). Every tile is a set of
// slabs, one TMA box each, out-of-bounds rows filled with zeros: 64-column
// slabs of 128-byte rows in the 128-byte swizzle where D is a multiple of
// 64 (64, 128, 192, 256), 16-column slabs of 32-byte rows in the 32-byte
// swizzle otherwise (D = 80). A wgmma reads 8 rows of 16 bytes at a time,
// which 128-byte rows in their swizzle spread over all the banks, the
// likely reason (not measured) that the wider slabs made gemma3's causal
// case about a fifth faster and D = 64 a little (chip_smoke.py before and
// after). For each tile a consumer warpgroup runs
//   S = Q·Kᵀ:  D/16 × wgmma m64nBKk16, both operands K-major in shared memory;
//   softmax in registers: ex2.approx with log2(e) folded into the scale,
//     masks only on diagonal, prefix-edge, window-edge and ragged tiles
//     (tiles wholly masked for the CTA's 128 rows are skipped, as the TPU
//     kernel does; a tile that starts inside the prefix is never skipped);
//   O += P·V:  BK/16 × wgmma m64nDk16, one product for every 16 keys across
//     all D columns (V's slabs LBO apart), P converted to bf16 in registers
//     as the A operand (the accumulator's layout is the A fragment's for
//     16-bit types), V the B operand read MN-major (transpose bit).
// S of a tile and P·V of the tile before it are issued together, and the
// softmax of the tile runs while that P·V product is on the tensor cores;
// O is rescaled once it lands. The two warpgroups take turns at issuing
// (named barriers), so that one's softmax also overlaps the other's
// products. The running max, sum and O accumulator stay in fp32 registers:
// at D = 256 a consumer thread holds 128 of O, 32 logits of S and 16 packed
// bf16 pairs of P across the loop, more than the 168 registers a thread
// that 384 threads leave, so `setmaxnreg` gives the producer warpgroup 24
// and each consumer warpgroup 240 (128·24 + 256·240 = 64,512 of the SM's
// 65,536). Where the probabilities are rounded depends on the key tiles
// (each is rounded against the running max of the tiles so far), so the
// plain version walks the same blocks (`flash_attention_wgmma_key_tile`,
// kernels/ref.wgmma_key_tile). One CTA an SM.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9; chip_smoke.py phase 10 prints it):
// every instance, D = 16 to 256, 168 registers at launch, 16 barriers, no
// stack frame and no spill. ptxas grants the consumers setmaxnreg's 240
// only where their code holds no trap: with the watchdog's __trap in their
// waits it kept them at 168, and the instances from D = 96 on spilled (a
// kilobyte at D = 256). So only the producer's waits trap
// (mbar_wait_or_trap), and it waits last for the consumers' release of
// every tile.
//
// What bounds it on this card. Causal attention needs 4·D flops for each
// (query, key) pair it keeps, per head: at B=1, S=4096, H=32, D=80 that is
// 85.9 GFLOP at the 989 TFLOP/s bf16 tensor rate (0.087 ms) against 83.9 MB
// at 3.35 TB/s (0.025 ms), so operations bound it; at gemma3's (1,4096,4,256)
// with one kv head, 34.4 GFLOP (0.0347 ms) against 21.0 MB (0.0063 ms).
// Behind the products come the exponentials: 64 a thread and 128-key tile
// at the SFU's 16 a clock and SM take about three quarters of the time of
// the tile's products at D = 80 (a third at D = 256), which the pipelining
// and the ping-pong hide behind the products. The grid sets a second floor:
// Sq/128 × H × B CTAs, 128 at gemma3's shape on 132 SMs, one wave whose
// longest CTA (the last 128 rows against all 4096 keys) does 537 MFLOP,
// 0.072 ms at one SM's share of the bf16 rate, about twice the aggregate
// bound; PaliGemma's (1,1280,8,256) gives 80 CTAs on 132 SMs. This floor
// is kept: splitting the longest rows' keys over two CTAs needs a second
// pass that merges their partial sums, and changes where P is rounded;
// giving each CTA one short and one long block of 64 rows was tried and
// did not shorten it, as a warpgroup left alone walks its keys no faster.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // query rows a CTA
// keys a tile: 128 up to D = 128, 64 above (D = 256's ring must fit)
__host__ __device__ constexpr int key_tile(int dt) { return dt <= 8 ? 128 : 64; }
// K/V ring depth: three stages while they fit beside the q tile (D <= 112)
__host__ __device__ constexpr int stages(int dt) { return dt <= 7 ? 3 : 2; }
constexpr int THREADS = 384;      // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24;   // setmaxnreg: 128·24 + 256·240 <= 384·168
constexpr int CONSUMER_REGS = 240;
// A tile in shared memory is a row of slabs, each of slab_cols(dt) columns
// of all the tile's rows, a row of a slab in its swizzle: 128-byte rows (64
// columns) in the 128-byte swizzle where D is a multiple of 64, 32-byte
// rows (16 columns) in the 32-byte swizzle otherwise, one TMA box a slab
// (the header says why the wider rows where they fit).
__host__ __device__ constexpr int slab_cols(int dt) { return dt % 4 == 0 ? 64 : 16; }
__host__ __device__ constexpr int row_bytes(int dt) { return 2 * slab_cols(dt); }
constexpr float NEG = -1e30f;     // the running max before any key
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// The producer's wait. A wait of more than 10 s can only be a fault (a
// load that never lands, so that its stage is never released): trap, so
// that the launch fails instead of hanging the card. Only the producer
// traps: a trap anywhere in the consumers' code keeps ptxas from giving
// them the registers that setmaxnreg grants (they then spill from D = 96
// on). The producer waits, last, until the consumers have released every
// tile, so that consumers stuck on a load that never lands end in its trap.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint64_t t0 = global_ns();
  while (!mbar_done(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// One TMA box of a (D, heads, S, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), layout type 1 (the 128-byte swizzle) for
// 128-byte rows, 3 (the 32-byte swizzle) for 32-byte rows.
template <int DT>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = row_bytes(DT) == 128 ? 1 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (layout << 62);
}

// Named barriers 1 and 2 (0 is __syncthreads): bar.sync waits, bar.arrive
// only counts; `n` threads in all complete a barrier.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups of products are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64×128 fp32) += A (64×16 bf16, K-major, shared) · B (16×128 bf16, K-major, shared)
// (scale_d 0: d is overwritten, not accumulated)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64×64 fp32) += A (64×16 bf16, K-major, shared) · B (16×64 bf16, K-major, shared)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The accumulator of an m64nNk16 product, N/2 fp32 registers a thread, as
// asm operands %6 onwards (after the six fixed ones of wgmma_rs), in
// strings of eight (FA_S*) and operand lists (FA_ACC8), accumulated by N.
#define FA_ACC8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_S0 "%6, %7, %8, %9, %10, %11, %12, %13"
#define FA_S1 "%14, %15, %16, %17, %18, %19, %20, %21"
#define FA_S2 "%22, %23, %24, %25, %26, %27, %28, %29"
#define FA_S3 "%30, %31, %32, %33, %34, %35, %36, %37"
#define FA_S4 "%38, %39, %40, %41, %42, %43, %44, %45"
#define FA_S5 "%46, %47, %48, %49, %50, %51, %52, %53"
#define FA_S6 "%54, %55, %56, %57, %58, %59, %60, %61"
#define FA_S7 "%62, %63, %64, %65, %66, %67, %68, %69"
#define FA_S8 "%70, %71, %72, %73, %74, %75, %76, %77"
#define FA_S9 "%78, %79, %80, %81, %82, %83, %84, %85"
#define FA_S10 "%86, %87, %88, %89, %90, %91, %92, %93"
#define FA_S11 "%94, %95, %96, %97, %98, %99, %100, %101"
#define FA_S12 "%102, %103, %104, %105, %106, %107, %108, %109"
#define FA_S13 "%110, %111, %112, %113, %114, %115, %116, %117"
#define FA_S14 "%118, %119, %120, %121, %122, %123, %124, %125"
#define FA_S15 "%126, %127, %128, %129, %130, %131, %132, %133"
#define FA_N16_S FA_S0
#define FA_N16_O FA_ACC8(0)
#define FA_N32_S FA_N16_S ", " FA_S1
#define FA_N32_O FA_N16_O, FA_ACC8(8)
#define FA_N48_S FA_N32_S ", " FA_S2
#define FA_N48_O FA_N32_O, FA_ACC8(16)
#define FA_N64_S FA_N48_S ", " FA_S3
#define FA_N64_O FA_N48_O, FA_ACC8(24)
#define FA_N80_S FA_N64_S ", " FA_S4
#define FA_N80_O FA_N64_O, FA_ACC8(32)
#define FA_N96_S FA_N80_S ", " FA_S5
#define FA_N96_O FA_N80_O, FA_ACC8(40)
#define FA_N112_S FA_N96_S ", " FA_S6
#define FA_N112_O FA_N96_O, FA_ACC8(48)
#define FA_N128_S FA_N112_S ", " FA_S7
#define FA_N128_O FA_N112_O, FA_ACC8(56)
#define FA_N144_S FA_N128_S ", " FA_S8
#define FA_N144_O FA_N128_O, FA_ACC8(64)
#define FA_N160_S FA_N144_S ", " FA_S9
#define FA_N160_O FA_N144_O, FA_ACC8(72)
#define FA_N176_S FA_N160_S ", " FA_S10
#define FA_N176_O FA_N160_O, FA_ACC8(80)
#define FA_N192_S FA_N176_S ", " FA_S11
#define FA_N192_O FA_N176_O, FA_ACC8(88)
#define FA_N208_S FA_N192_S ", " FA_S12
#define FA_N208_O FA_N192_O, FA_ACC8(96)
#define FA_N224_S FA_N208_S ", " FA_S13
#define FA_N224_O FA_N208_O, FA_ACC8(104)
#define FA_N240_S FA_N224_S ", " FA_S14
#define FA_N240_O FA_N224_O, FA_ACC8(112)
#define FA_N256_S FA_N240_S ", " FA_S15
#define FA_N256_O FA_N240_O, FA_ACC8(120)

// d (64×N fp32) += A (64×16 bf16, registers) · B (16×N bf16, MN-major,
// shared), N a multiple of 16 up to 256. The A registers, B's descriptor
// and the accumulate flag come first, as read-write operands, so that the
// accumulator's operand numbers do not depend on N. A is bound in place,
// not copied: the product reads it after the instruction issues, so its
// registers must stay as they are until the wait (a copy would be free for
// reuse at once).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, uint32_t (&a)[4], uint64_t db) {
  uint32_t one = 1;
#define FA_RS_CASE(NN)                                                                      \
  if constexpr (N == NN)                                                                    \
    asm volatile("{\n"                                                                      \
                 ".reg .pred p;\n"                                                          \
                 "setp.ne.b32 p, %5, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 "               \
                 "{" FA_N##NN##_S "}, {%0, %1, %2, %3}, %4, p, 1, 1, 1;\n"                  \
                 "}\n"                                                                      \
                 : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(db), "+r"(one),     \
                   FA_N##NN##_O);
  FA_RS_CASE(16) FA_RS_CASE(32) FA_RS_CASE(48) FA_RS_CASE(64) FA_RS_CASE(80) FA_RS_CASE(96)
  FA_RS_CASE(112) FA_RS_CASE(128) FA_RS_CASE(144) FA_RS_CASE(160) FA_RS_CASE(176)
  FA_RS_CASE(192) FA_RS_CASE(208) FA_RS_CASE(224) FA_RS_CASE(240) FA_RS_CASE(256)
#undef FA_RS_CASE
}

// The shared-memory addresses are passed through an empty asm at every
// tile, so that the compiler derives each product's descriptor right where
// it issues the product rather than holding all of them across the loop
// (at D = 256 the q and K descriptors of a tile could take 64 registers).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// S (64×BK) = Q (64×D, shared) · Kᵀ: D/16 products, issued, not waited for.
// Both operands K-major: 8-row groups 8 rows apart (SBO), the product of
// 16 columns j at 32·j bytes into its slab's rows (the swizzle applies to
// the address the start field makes).
template <int DT>
__device__ __forceinline__ void issue_qk(float (&sc)[key_tile(DT) / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  constexpr int RB = row_bytes(DT), KS = slab_cols(DT) / 16;
  const uint64_t dq = desc<DT>(opaque(q_addr), 16, 8 * RB);
  const uint64_t dk = desc<DT>(opaque(k_addr), 16, 8 * RB);
#pragma unroll
  for (int j = 0; j < DT; ++j) {  // the start address field steps in 16-byte units
    const int slab = j / KS, off = (j % KS) * 32;
    const uint64_t da = dq + ((slab * BM * RB + off) >> 4);
    const uint64_t db = dk + ((slab * key_tile(DT) * RB + off) >> 4);
    if constexpr (key_tile(DT) == 128) wgmma_m64n128k16_ss(sc, da, db, j > 0);
    else wgmma_m64n64k16_ss(sc, da, db, j > 0);
  }
}

// O (64×D) += P (64×BK, bf16 registers) · V (BK×D, shared, MN-major),
// issued: one m64nDk16 product for each 16 keys, V's slabs LBO apart, its
// 8-key groups 8 rows apart (SBO).
template <int DT>
__device__ __forceinline__ void issue_pv(float (&o)[8 * DT], uint32_t (&pa)[key_tile(DT) / 16][4],
                                         uint32_t v_addr) {
  constexpr int RB = row_bytes(DT);
  const uint64_t dv = desc<DT>(opaque(v_addr), key_tile(DT) * RB, 8 * RB);
#pragma unroll
  for (int kk = 0; kk < key_tile(DT) / 16; ++kk)  // 16 keys: 16 rows
    wgmma_rs<16 * DT>(o, pa[kk], dv + ((kk * 16 * RB) >> 4));
}

// 2^x on the SFU (ex2.approx, flushing subnormal results to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of a CTA: the q tile, the K and V rings, the barriers
// (kernels/flash_attention.py: wgmma_shared_memory_bytes, which adds the
// 1 KB of alignment slack that launch() asks for).
__host__ __device__ constexpr int smem_bytes(int dt) {
  return dt * 32 * (BM + 2 * stages(dt) * key_tile(dt)) + 8 * (1 + 4 * stages(dt));
}

template <int DT>  // D / 16
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
                       int causal, int has_window, int window, int q_offset, int prefix_len,
                       float scale_log2) {
  constexpr int D = 16 * DT, STAGES = stages(DT), BK = key_tile(DT);
  constexpr int W = slab_cols(DT), RB = row_bytes(DT), SLABS = D / W;
  constexpr int SLAB_Q = BM * RB, SLAB_KV = BK * RB;  // bytes of a slab of a q, K or V tile
  constexpr int TILE_KV = SLABS * SLAB_KV;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment keeps every slab's swizzle pattern in phase
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                    // SLABS slabs of 128 rows
  uint8_t* Ks = Qs + SLABS * SLAB_Q;      // STAGES tiles of SLABS slabs of BK rows
  uint8_t* Vs = Ks + STAGES * TILE_KV;
  // K and V each have their own full/empty barriers: a K tile is released
  // once S of its tile has landed, a round before its V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE_KV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / (H / KV);
  const int row0 = iq * BM;

  // the key tiles any row of the CTA keeps (the TPU kernel's tile test; a
  // tile that starts inside the prefix is kept whatever the rows)
  const int a_lo = row0 + q_offset, a_hi = a_lo + BM - 1;
  const int k_end = causal ? min(Sk, max(a_hi + 1, prefix_len)) : Sk;
  const int k_begin = has_window ? max(0, a_lo - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int ntiles = k_end > kt0 * BK ? (k_end - kt0 * BK + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform (a shuffle from lane 0), as setmaxnreg's branches must be
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 256 || ntiles == 0) return;
    mbar_expect_tx(q_full, SLABS * SLAB_Q);
    for (int j = 0; j < SLABS; ++j) tma_load_4d(Qs + j * SLAB_Q, &tmap_q, q_full, W * j, hi, row0, bi);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int k_lo = (kt0 + it) * BK;
      mbar_wait_or_trap(&k_empty[s], ph ^ 1);
      mbar_expect_tx(&k_full[s], TILE_KV);
      for (int j = 0; j < SLABS; ++j)
        tma_load_4d(Ks + s * TILE_KV + j * SLAB_KV, &tmap_k, &k_full[s], W * j, kvh, k_lo, bi);
      mbar_wait_or_trap(&v_empty[s], ph ^ 1);
      mbar_expect_tx(&v_full[s], TILE_KV);
      for (int j = 0; j < SLABS; ++j)
        tma_load_4d(Vs + s * TILE_KV + j * SLAB_KV, &tmap_v, &v_full[s], W * j, kvh, k_lo, bi);
    }
    // the consumers' release of the last V tiles: the end of their loads
    for (int it = max(0, ntiles - STAGES); it < ntiles; ++it)
      mbar_wait_or_trap(&v_empty[it % STAGES], (it / STAGES) & 1);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // ---- consumers: warpgroup wg owns rows row0 + 64·wg .. +63 ----
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4;  // this thread's rows: r and r + 8 of the 64
  const int cq = 2 * (lane % 4);       // and columns cq, cq + 1 of every 8
  const int wa_lo = a_lo + 64 * wg;    // the warpgroup's first query position
  const int qpos0 = wa_lo + r, qpos1 = qpos0 + 8;

  float o[8 * DT];
#pragma unroll
  for (int i = 0; i < 8 * DT; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * RB;

  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);

  // softmax of the tile in sc, in place: masks where the tile needs them,
  // the new running max, p = exp(s − m) (exp2 with log2(e) in the scale),
  // the sums; returns the factors that rescale the older accumulator
  float sc[BK / 2];
  auto softmax = [&](int it, float& corr0, float& corr1) {
    const int k_lo = (kt0 + it) * BK, k_last = k_lo + BK - 1;
    // a causal mask bites where a key lies past a row and past the prefix
    const bool need_mask = (causal && k_last > wa_lo && k_last >= prefix_len) ||
                           (has_window && k_lo <= wa_lo + 63 - window) || (k_lo + BK > Sk);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k_lo + 8 * (i / 4) + cq + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool keep = col < Sk && (!causal || col <= qp || col < prefix_len) &&
                          (!has_window || col > qp - window);
        if (!keep) sc[i] = -INFINITY;  // exp2 gives exactly 0
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    corr0 = fast_exp2((m0 - mx0) * scale_log2);
    corr1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = fast_exp2(fmaf(sc[i], scale_log2, (i & 2) ? -mb1 : -mb0));
      sc[i] = p;
      if (i & 2) ps1 += p;
      else ps0 += p;
    }
    l0 = fmaf(l0, corr0, ps0);
    l1 = fmaf(l1, corr1, ps1);
  };
  uint32_t pa[BK / 16][4];  // P in bf16: the A operand of O += P·V
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
  };

  // The two warpgroups take turns at issuing their products (FA3's
  // ping-pong): a warpgroup waits at its own named barrier before it issues
  // and releases the other's after, so that one's softmax overlaps the
  // other's products. Both walk every tile of the CTA (a tile wholly masked
  // for one warpgroup's rows adds exactly nothing to it), so their turns
  // pair up; warpgroup 0 goes first.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) named_arrive(their_turn, CONSUMERS);
  if (ntiles > 0) {  // else no key: q is not loaded, and the rows come out 0
    // The first tile alone; then each step issues S of tile `it` and
    // O += P·V of tile it − 1 together, runs the softmax of tile `it` while
    // the P·V product is on the tensor cores, and only then rescales O.
    float corr0, corr1;
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    fence_regs(sc);
    named_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_qk<DT>(sc, q_addr, k_base);
    wgmma_commit();
    named_arrive(their_turn, CONSUMERS);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&k_empty[0]);
    softmax(0, corr0, corr1);
    pack();
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(&k_full[s], (it / STAGES) & 1);
      mbar_wait(&v_full[sp], ((it - 1) / STAGES) & 1);
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      named_sync(my_turn, CONSUMERS);
      wgmma_fence();
      issue_qk<DT>(sc, q_addr, k_base + s * TILE_KV);
      wgmma_commit();
      issue_pv<DT>(o, pa, v_base + sp * TILE_KV);
      wgmma_commit();
      named_arrive(their_turn, CONSUMERS);
      wgmma_wait<1>();  // S of tile it
      fence_regs(sc);
      mbar_arrive(&k_empty[s]);
      softmax(it, corr0, corr1);
      wgmma_wait<0>();  // P·V of tile it − 1
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int i = 0; i < 8 * DT; ++i) o[i] *= (i & 2) ? corr1 : corr0;
      pack();
    }
    const int sl = (ntiles - 1) % STAGES;
    mbar_wait(&v_full[sl], ((ntiles - 1) / STAGES) & 1);
    fence_regs(o);
    fence_regs(pa);
    named_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_pv<DT>(o, pa, v_base + sl * TILE_KV);
    wgmma_commit();
    named_arrive(their_turn, CONSUMERS);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&v_empty[sl]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int row_a = row0 + 64 * wg + r, row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = 16 * j + 8 * g + cq;
      const float* v = &o[8 * j + 4 * g];
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + ((long long)(bi * Sq + row_a) * H + hi) * D + col) =
            __floats2bfloat162_rn(v[0] / den0, v[1] / den0);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + ((long long)(bi * Sq + row_b) * H + hi) * D + col) =
            __floats2bfloat162_rn(v[2] / den1, v[3] / den1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime: the
// library is not linked against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, heads, S, B) bf16 map with boxes of one slab (slab_cols columns) of
// `rows` rows in the slab's swizzle, zeros out of bounds. `st` holds the
// element strides of B, S and heads, each a multiple of 8; D is contiguous.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads,
                  int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const int cols = slab_cols(D / 16);
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DT>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int has_window, int window, int q_offset,
           int prefix_len, float scale_log2, cudaStream_t stream) {
  const int smem = smem_bytes(DT) + 1024;  // + the alignment slack
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // a refusal is also the runtime's last error: clear it, or the next
  // launch's cudaGetLastError would report it
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_fwd_wgmma_kernel<DT><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal, has_window, window,
      q_offset, prefix_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool takes_head_dim(int D) { return D >= 16 && D <= 256 && D % 16 == 0; }

}  // namespace

// q, k, v bf16 with D contiguous, 16-byte aligned, the other `strides`
// (host memory; 12 element strides, four each of q, k and v) multiples of
// 8; out (B,Sq,H,D) bf16 contiguous; D a multiple of 16 up to 256;
// prefix_len >= 0 (0: no prefix). `scale` is 1/sqrt(D), rounded to fp32 by
// the caller. Returns 0, a cudaError_t, -1 when libcuda's
// cuTensorMapEncodeTiled is not found, or -(1000 + CUresult) when it
// refuses a map.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int KV, int D, int causal,
                                         int has_window, int window, int q_offset, int prefix_len,
                                         float scale, const long long* strides, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 || !takes_head_dim(D) ||
      prefix_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const int bk = key_tile(D / 16);
  CUtensorMap mq, mk, mv;
  CUresult res = make_map(encode, &mq, q, B, Sq, H, D, strides, BM);
  if (res == CUDA_SUCCESS) res = make_map(encode, &mk, k, B, Sk, KV, D, strides + 4, bk);
  if (res == CUDA_SUCCESS) res = make_map(encode, &mv, v, B, Sk, KV, D, strides + 8, bk);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  const float sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
#define FA_CASE(N)                                                                          \
  case N:                                                                                   \
    return launch<N>(mq, mk, mv, out, B, Sq, Sk, H, KV, causal, has_window, window, q_offset, \
                     prefix_len, sl2, s);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
    FA_CASE(9) FA_CASE(10) FA_CASE(11) FA_CASE(12) FA_CASE(13) FA_CASE(14) FA_CASE(15)
    FA_CASE(16)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a CTA asks for at head dim D (alignment slack
// included), in bytes; -1 for a D the kernel does not take.
extern "C" long long flash_attention_wgmma_smem(int D) {
  if (!takes_head_dim(D)) return -1;
  return smem_bytes(D / 16) + 1024;
}

// The keys of one K/V tile at head dim D (the blocks whose probabilities
// are rounded together: kernels/ref.wgmma_key_tile); -1 for a D the kernel
// does not take.
extern "C" int flash_attention_wgmma_key_tile(int D) {
  if (!takes_head_dim(D)) return -1;
  return key_tile(D / 16);
}
