// Causal, sliding-window, grouped-query attention forward pass on Hopper's
// tensor cores (sm_90a): bf16 q, k, v with a head dim D that is a multiple
// of 16 and at most 128. fp32 inputs, and other head dims, take the CUDA-core
// kernel of flash_attention.cu (the wrapper's dispatch).
//
// Replaces, with flash_attention.cu, the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py: `_fa_kernel` and its wrapper
// `flash_attention_pallas`.
//
// What it computes, for q (B,Sq,H,D) and k, v (B,Sk,KV,D), all bf16, with
// query head h reading kv head h / (H/KV), qpos_i = i + q_offset:
//   s[i,j] = (q_i · k_j) in fp32 from exact bf16 products, times scale;
//   kept where j < Sk, j <= qpos_i when causal, j > qpos_i − window with a
//   window; a masked logit adds exactly 0 (a row with no key comes out 0);
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
// 128-key K and V tiles in flight through a ring in shared memory (three
// stages up to D = 112, two above), guarded by full/empty mbarriers. Every
// tile is a set of 16-column slabs of 32-byte rows in the 32-byte swizzle
// (D = 80 is five slabs; a 128-byte swizzle atom would need D a multiple of
// 64), one TMA box each, out-of-bounds rows filled with zeros. For each
// tile a consumer warpgroup runs
//   S = Q·Kᵀ:  D/16 × wgmma m64n128k16, both operands K-major in shared memory;
//   softmax in registers: ex2.approx with log2(e) folded into the scale,
//     masks only on diagonal, window-edge and ragged tiles (tiles wholly
//     masked for the CTA's 128 rows are skipped, as the TPU kernel does);
//   O += P·V:  8 × wgmma m64n80k16 at D = 80 (8 × D/16 × m64n16k16 at other
//     head dims), P converted to bf16 in registers as the A operand (the
//     accumulator's layout is the A fragment's for 16-bit types), V the B
//     operand read MN-major (transpose bit).
// S of a tile and P·V of the tile before it are issued together, and the
// softmax of the tile runs while that P·V product is on the tensor cores;
// O is rescaled once it lands. The two warpgroups take turns at issuing
// (named barriers), so that one's softmax also overlaps the other's
// products. The running max, sum and O accumulator stay
// in fp32 registers. Where the probabilities are rounded depends on the key
// tiles (each is rounded against the running max of the tiles so far), so
// the plain version walks the same 128-key blocks. Shared memory at D = 80:
// 144,440 bytes, one CTA an SM.
//
// What bounds it on this card. Causal attention needs 4·D flops for each
// (query, key) pair it keeps, per head: at B=1, S=4096, H=32, D=80 that is
// 85.9 GFLOP at the 989 TFLOP/s bf16 tensor rate (0.087 ms) against 83.9 MB
// at 3.35 TB/s (0.025 ms), so operations bound it. Behind them come the
// exponentials: 64 a thread and tile at the SFU's 16 a clock and SM take
// about three quarters of the time of the tile's products at D = 80, which
// the pipelining and the ping-pong hide behind the products.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // query rows a CTA
constexpr int BK = 128;           // keys a tile
// K/V ring depth: three stages while they fit beside the q tile (D <= 112)
__host__ __device__ constexpr int stages(int dt) { return dt <= 7 ? 3 : 2; }
constexpr int THREADS = 384;      // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int SLAB_Q = BM * 32;   // bytes of one 16-column slab of the q tile
constexpr int SLAB_KV = BK * 32;  // bytes of one 16-column slab of a K or V tile
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

// Wait until the barrier's phase of the given parity has completed. A wait
// of more than 10 s can only be a fault (a load that never lands): trap, so
// that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const uint64_t t0 = global_ns();
  uint32_t done = 0;
  do {
    if (global_ns() - t0 > 10000000000ull) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
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

// wgmma shared-memory descriptor for the 32-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 3.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (3ull << 62);
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

// d (64×80 fp32) += A (64×16 bf16, registers) · B (16×80 bf16, MN-major, shared)
__device__ __forceinline__ void wgmma_m64n80k16_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64×16 fp32) += A (64×16 bf16, registers) · B (16×16 bf16, MN-major, shared)
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (64×128) = Q (64×D, shared) · Kᵀ: D/16 products, issued, not waited for.
template <int DT>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int j = 0; j < DT; ++j)
    wgmma_m64n128k16_ss(sc, desc_sw32(q_addr + j * SLAB_Q, 16, 256),
                        desc_sw32(k_addr + j * SLAB_KV, 16, 256), j > 0);
}

// O (64×D) += P (64×128, bf16 registers) · V (128×D, shared, MN-major), issued.
template <int DT>
__device__ __forceinline__ void issue_pv(float (&o)[8 * DT], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (DT == 5) {  // D = 80 in one product: the five slabs LBO apart
      wgmma_m64n80k16_rs(o, pa[kk], desc_sw32(v_addr + kk * 16 * 32, SLAB_KV, 256));
    } else {
#pragma unroll
      for (int j = 0; j < DT; ++j)
        wgmma_m64n16k16_rs(&o[8 * j], pa[kk],
                           desc_sw32(v_addr + j * SLAB_KV + kk * 16 * 32, SLAB_KV, 256));
    }
  }
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
  return dt * (SLAB_Q + 2 * stages(dt) * SLAB_KV) + 8 * (1 + 2 * stages(dt));
}

template <int DT>  // D / 16
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
                       int causal, int has_window, int window, int q_offset, float scale_log2) {
  constexpr int D = 16 * DT, STAGES = stages(DT);
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment keeps every slab's swizzle pattern in phase
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                                 // DT slabs of 128 rows
  uint8_t* Ks = Qs + DT * SLAB_Q;                     // STAGES × DT slabs of 128 rows
  uint8_t* Vs = Ks + STAGES * DT * SLAB_KV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * DT * SLAB_KV);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / (H / KV);
  const int row0 = iq * BM;

  // the key tiles any row of the CTA keeps (the TPU kernel's tile test)
  const int a_lo = row0 + q_offset, a_hi = a_lo + BM - 1;
  const int k_end = causal ? min(Sk, a_hi + 1) : Sk;
  const int k_begin = has_window ? max(0, a_lo - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int ntiles = k_end > kt0 * BK ? (k_end - kt0 * BK + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, DT * SLAB_Q);
    for (int j = 0; j < DT; ++j) tma_load_4d(Qs + j * SLAB_Q, &tmap_q, q_full, 16 * j, hi, row0, bi);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int k_lo = (kt0 + it) * BK;
      mbar_wait(&empty[s], ph ^ 1);
      mbar_expect_tx(&full[s], 2 * DT * SLAB_KV);
      for (int j = 0; j < DT; ++j) {
        tma_load_4d(Ks + (s * DT + j) * SLAB_KV, &tmap_k, &full[s], 16 * j, kvh, k_lo, bi);
        tma_load_4d(Vs + (s * DT + j) * SLAB_KV, &tmap_v, &full[s], 16 * j, kvh, k_lo, bi);
      }
    }
    return;
  }

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
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 32;

  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);

  // softmax of the tile in sc, in place: masks where the tile needs them,
  // the new running max, p = exp(s − m) (exp2 with log2(e) in the scale),
  // the sums; returns the factors that rescale the older accumulator
  float sc[BK / 2];
  auto softmax = [&](int it, float& corr0, float& corr1) {
    const int k_lo = (kt0 + it) * BK;
    const bool need_mask = (causal && k_lo + BK - 1 > wa_lo) ||
                           (has_window && k_lo <= wa_lo + 63 - window) || (k_lo + BK > Sk);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k_lo + 8 * (i / 4) + cq + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool keep = col < Sk && (!causal || col <= qp) && (!has_window || col > qp - window);
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
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    // The first tile alone; then each step issues S of tile `it` and
    // O += P·V of tile it − 1 together, runs the softmax of tile `it` while
    // the P·V product is on the tensor cores, and only then rescales O.
    float corr0, corr1;
    mbar_wait(&full[0], 0);
    fence_regs(sc);
    named_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_qk<DT>(sc, q_addr, k_base);
    wgmma_commit();
    named_arrive(their_turn, CONSUMERS);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, corr0, corr1);
    pack();
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      named_sync(my_turn, CONSUMERS);
      wgmma_fence();
      issue_qk<DT>(sc, q_addr, k_base + s * DT * SLAB_KV);
      wgmma_commit();
      issue_pv<DT>(o, pa, v_base + sp * DT * SLAB_KV);
      wgmma_commit();
      named_arrive(their_turn, CONSUMERS);
      wgmma_wait<1>();  // S of tile it
      fence_regs(sc);
      softmax(it, corr0, corr1);
      wgmma_wait<0>();  // P·V of tile it − 1
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&empty[sp]);
#pragma unroll
      for (int i = 0; i < 8 * DT; ++i) o[i] *= (i & 2) ? corr1 : corr0;
      pack();
    }
    const int sl = (ntiles - 1) % STAGES;
    fence_regs(o);
    fence_regs(pa);
    named_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_pv<DT>(o, pa, v_base + sl * DT * SLAB_KV);
    wgmma_commit();
    named_arrive(their_turn, CONSUMERS);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[sl]);
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

// A (D, heads, S, B) bf16 map with 16-column boxes of `rows` rows, 32-byte
// swizzle, zeros out of bounds. `st` holds the element strides of B, S and
// heads, each a multiple of 8; D is contiguous.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads,
                  int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DT>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int has_window, int window, int q_offset,
           float scale_log2, cudaStream_t stream) {
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
      q_offset, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v bf16 with D contiguous, 16-byte aligned, the other `strides`
// (host memory; 12 element strides, four each of q, k and v) multiples of
// 8; out (B,Sq,H,D) bf16 contiguous; D a multiple of 16 up to 128. `scale`
// is 1/sqrt(D), rounded to fp32 by the caller. Returns 0, a cudaError_t,
// -1 when libcuda's cuTensorMapEncodeTiled is not found, or
// -(1000 + CUresult) when it refuses a map.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int KV, int D, int causal,
                                         int has_window, int window, int q_offset, float scale,
                                         const long long* strides, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 16 || D > 128 ||
      D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap mq, mk, mv;
  CUresult res = make_map(encode, &mq, q, B, Sq, H, D, strides, BM);
  if (res == CUDA_SUCCESS) res = make_map(encode, &mk, k, B, Sk, KV, D, strides + 4, BK);
  if (res == CUDA_SUCCESS) res = make_map(encode, &mv, v, B, Sk, KV, D, strides + 8, BK);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  const float sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
#define FA_CASE(N) \
  case N:          \
    return launch<N>(mq, mk, mv, out, B, Sq, Sk, H, KV, causal, has_window, window, q_offset, sl2, s);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a CTA asks for at head dim D (alignment slack
// included), in bytes; -1 for a D the kernel does not take.
extern "C" long long flash_attention_wgmma_smem(int D) {
  if (D < 16 || D > 128 || D % 16 != 0) return -1;
  return smem_bytes(D / 16) + 1024;
}
