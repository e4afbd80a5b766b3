// Chunked diagonal-gated linear recurrence for Hopper (sm_90a): the core of
// RWKV-6 time mixing and of Mamba2 (SSD).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssm_scan.py:
// `_ssm_chunk_kernel` and its wrapper `ssm_scan_pallas`.
//
// What it computes, for every batch row b and head h:
//   h_t = a_t ⊙ h_{t-1} + b_t ⊗ x_t     (state (N, P), fp32, h_0 = 0)
//   y_t = h_tᵀ c_t
// with x (B,S,H,P), b and c (B,S,H,N) in one type (fp32 or bf16), a in fp32,
// either (B,S,H,N) per channel (RWKV-6) or (B,S,H) per head (Mamba2). It
// returns y in x's type and the final state in fp32. In chunks of C tokens,
// in log space, with L_t = Σ_{i≤t} log a_i counted from the chunk's start:
//   s[t,i]  = Σ_n c[t,n] exp(L[t,n] − L[i,n]) b[i,n]   for i ≤ t, else 0
//   local_k = (b ⊙ exp(L_last − L))ᵀ x,   decay_k = exp(L_last)
//   h_k     = decay_k ⊙ h_{k−1} + local_k                (h_{−1} = 0)
//   y       = s x + (c ⊙ exp(L)) h_{k−1}     (per head: exp(L) scales rows)
// Every exponent is ≤ 0: nothing overflows, and nothing divides by a
// cumulative decay that may have underflowed (a = 1e-6 stays exact). With a
// per-head decay L is one number a token, so s = (c bᵀ) ⊙ exp(L_t − L_i):
// a plain (C,N)·(N,C) product and C² exponentials a chunk, not C²·N.
//
// Design: three launches, parallel over (batch, head, chunk) except for the
// short pass that carries the state from chunk to chunk.
//   1. ssm_state_kernel, one 256-thread block per (chunk, head, batch):
//      loads the chunk, takes L by a warp-shuffle scan (one warp a channel),
//      writes decay_k and local_k into the (B,H,chunks,N,P) scratch.
//   2. ssm_carry_kernel, one thread per four (batch, head, n, p): walks the
//      chunks in order, turning local_k in place into the carry-in state
//      h_{k−1} of chunk k, and writes h_final. N·P work a chunk.
//   3. ssm_output_kernel, one block per (chunk, head, batch): reloads the
//      chunk, builds s, and writes y = s x + (c ⊙ exp(L)) h_{k−1}.
// The products run from shared memory on the CUDA cores in fp32, 4×4
// outputs a thread (a 16×16 grid of threads covers a 64×64 tile), operands
// stored k-major so that each step is two 16-byte loads and 16 FMAs. The
// reference's 2e-4 bar rules out TF32. Inputs are staged 16 bytes a thread
// where their rows allow it; tiles are padded to a multiple of 4 floats
// (rows that are stored transposed to 4 more, so that the stores spread
// over the banks); a ragged last chunk reads a = 1 and b = c = x = 0 past
// the end. Shared memory at C = N = P = 64: pass 1 33 KB (per head) or
// 50 KB (per channel); pass 3 69 KB or 86 KB, so three or two blocks an SM.
//
// What bounds it on this card. The recurrence needs about 5·N·P flops a
// token and head and the inputs and outputs are read and written once: at
// Mamba2's (1,4096,80,64) with N = 64, bf16 x/b/c/y, 6.7 GFLOP at the 67
// TFLOP/s fp32 rate (0.100 ms) against 126 MB at 3.35 TB/s. The chunked
// form does about 2.5× the flops of the recurrence (s, s·x, c·h, bᵀx), and
// the state scratch is written, read and written again, and read: 4 × 84 MB
// at that shape, 0.1 ms of memory traffic on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // output tile of the 16×16 thread grid, 4×4 a thread

// Element strides of the (B, S, H, last) dims of each input.
struct Strides {
  long long x[4], a[4], b[4], c[4];
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four fp32 values of consecutive outputs: one 16- or 8-byte store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}


// The 16 bytes of r as fp32: four floats or eight bf16.
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x), v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z), v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage the chunk's rows of one (batch, head) of a (B,S,H,width) input in
// shared memory as fp32: dst[t·ld + j], or dst[j·ld + t] when TRANSPOSE;
// rows t >= len read 0. With `vec` (the width contiguous, every row 16-byte
// aligned) a thread moves 16 bytes at a time; the transposed form gives
// neighbouring threads neighbouring tokens, so its shared stores do not
// collide.
template <bool TRANSPOSE, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long row_stride,
                                      long long col_stride, int t0, int len, int C, int width,
                                      bool vec) {
  constexpr int V = 16 / sizeof(T), U = 4;  // U loads in flight before their stores
  if (vec) {
    const int nv = width / V, total = C * nv;
    for (int q0 = threadIdx.x; q0 < total; q0 += U * THREADS) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * THREADS;
        const int t = TRANSPOSE ? q % C : q / nv, j = (TRANSPOSE ? q / C : q % nv) * V;
        if (q < total && t < len) {
          unpack(*reinterpret_cast<const uint4*>(src + (long long)(t0 + t) * row_stride + j),
                 v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * THREADS;
        if (q >= total) break;
        const int t = TRANSPOSE ? q % C : q / nv, j = (TRANSPOSE ? q / C : q % nv) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (TRANSPOSE) dst[(j + e) * ld + t] = v[u][e];
          else dst[t * ld + j + e] = v[u][e];
        }
      }
    }
  } else {
    for (int q = threadIdx.x; q < C * width; q += THREADS) {
      const int t = q / width, j = q % width;
      const float v = t < len ? load_f(src + (long long)(t0 + t) * row_stride + j * col_stride) : 0.f;
      if (TRANSPOSE) dst[j * ld + t] = v;
      else dst[t * ld + j] = v;
    }
  }
}

// A tile staged in two steps, so that the loads of several tiles are in
// flight together: fetch() issues this thread's 16-byte loads (at most U,
// kept raw in registers), place() converts them to fp32 and stores them as
// stage() would. For tiles whose rows allow 16-byte loads and that need at
// most U pieces a thread (64 rows of 64 bf16 values need two).
template <typename T>
struct Pieces {
  static constexpr int V = 16 / sizeof(T), U = 2;
  uint4 raw[U];

  __device__ static bool fits(int C, int width, bool vec) {
    return vec && C * (width / V) <= U * THREADS;
  }

  __device__ __forceinline__ void fetch(const T* src, long long row_stride, int t0, int len,
                                        int C, int width, bool transpose) {
    const int nv = width / V, total = C * nv;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = threadIdx.x + u * THREADS;
      const int t = transpose ? q % C : q / nv, j = (transpose ? q / C : q % nv) * V;
      raw[u] = q < total && t < len
                   ? *reinterpret_cast<const uint4*>(src + (long long)(t0 + t) * row_stride + j)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void place(float* dst, int ld, int C, int width,
                                        bool transpose) const {
    const int nv = width / V, total = C * nv;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = threadIdx.x + u * THREADS;
      if (q >= total) break;
      const int t = transpose ? q % C : q / nv, j = (transpose ? q / C : q % nv) * V;
      float v[V];
      unpack(raw[u], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (transpose) dst[(j + e) * ld + t] = v[e];
        else dst[t * ld + j + e] = v[e];
      }
    }
  }
};

// acc[i][j] += Σ_{k0≤k<k1} A[k·lda + m0 + i] · B[k·ldb + n0 + j]: both
// operands k-major in shared memory, 16-byte aligned rows.
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* A, int lda,
                                      const float* B, int ldb, int k0, int k1, int m0, int n0) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + m0);
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + n0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Inclusive running sum along t of each of the nl rows of Ls (row length
// ld, C real values): one warp a row, 32 tokens a step with a carry.
__device__ __forceinline__ void scan_rows(float* Ls, int ld, int nl, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nl; r += THREADS / 32) {
    float carry = 0.f;
    for (int t0 = 0; t0 < C; t0 += 32) {
      const int t = t0 + lane;
      float v = t < C ? Ls[r * ld + t] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (t < C) Ls[r * ld + t] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// Load log a of the chunk into Ls (nl rows of ld, channel-major): per head
// one row; rows past the end read a = 1.
__device__ __forceinline__ void load_log_a(float* Ls, int ld, const float* ab, const Strides& st,
                                           int t0, int len, int C, int nl) {
  for (int q = threadIdx.x; q < C * nl; q += THREADS) {
    const int t = q / nl, n = q % nl;
    float la = 0.f;
    if (t < len)
      la = logf(fmaxf(ab[(long long)(t0 + t) * st.a[1] + (long long)n * st.a[3]], 1e-37f));
    Ls[n * ld + t] = la;
  }
}

// Pass 1: the chunk's decay exp(L_last) and local state (b ⊙ exp(L_last − L))ᵀ x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_state_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ state, float* __restrict__ decay, int S, int H, int N, int P,
                 int C, int per_head, int vec, Strides st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N4 = round4(N), P4 = round4(P), LT = round4(C) + 4, nl = per_head ? 1 : N;
  float* xs = smem;         // (C, P4)
  float* bs = xs + C * P4;  // (C, N4): b, then b ⊙ exp(L_last − L)
  float* Ls = bs + C * N4;  // (nl, LT): log a, then L

  const int k = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z, nc = gridDim.x;
  const int t0 = k * C, len = min(C, S - t0);
  const T* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = a + bi * st.a[0] + hi * st.a[2];
  const T* bb = b + bi * st.b[0] + hi * st.b[2];

  if (Pieces<T>::fits(C, P, vec & 1) && Pieces<T>::fits(C, N, vec & 2)) {
    Pieces<T> px, pb;  // both tiles' loads and a's in flight together
    px.fetch(xb, st.x[1], t0, len, C, P, false);
    pb.fetch(bb, st.b[1], t0, len, C, N, false);
    load_log_a(Ls, LT, ab, st, t0, len, C, nl);
    px.place(xs, P4, C, P, false);
    pb.place(bs, N4, C, N, false);
  } else {
    stage<false>(xs, P4, xb, st.x[1], st.x[3], t0, len, C, P, vec & 1);
    stage<false>(bs, N4, bb, st.b[1], st.b[3], t0, len, C, N, vec & 2);
    load_log_a(Ls, LT, ab, st, t0, len, C, nl);
  }
  __syncthreads();
  scan_rows(Ls, LT, nl, C);
  __syncthreads();

  const long long chunk_id = ((long long)bi * H + hi) * nc + k;
  for (int n = threadIdx.x; n < nl; n += THREADS) decay[chunk_id * nl + n] = expf(Ls[n * LT + C - 1]);
  for (int q = threadIdx.x; q < C * N; q += THREADS) {
    const int t = q / N, n = q % N, r = per_head ? 0 : n;
    bs[t * N4 + n] *= expf(Ls[r * LT + C - 1] - Ls[r * LT + t]);
  }
  __syncthreads();

  // local[n, p] = Σ_t b'[t, n] x[t, p]
  float* out = state + chunk_id * N * P;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int m0 = 4 * ty; m0 < N; m0 += TILE)
    for (int n0 = 4 * tx; n0 < P; n0 += TILE) {
      float acc[4][4];
      zero(acc);
      mm4x4(acc, bs, N4, xs, P4, 0, C, m0, n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + i >= N) break;
        float* o = out + (m0 + i) * P + n0;
        if (P % 4 == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < P) o[j] = acc[i][j];
        }
      }
    }
}

// Pass 2: h_k = decay_k ⊙ h_{k−1} + local_k, in order over the chunks; the
// scratch's chunk k is left holding h_{k−1}, and h_final goes to hout. A
// thread owns W consecutive state values of one row n (W = 4 when P allows,
// so each chunk is one 16-byte load and store) and keeps DEPTH chunks' loads
// in flight: each store goes to a chunk whose load has already been issued.
template <int W>
__global__ void __launch_bounds__(THREADS, 4)
ssm_carry_kernel(float* __restrict__ state, const float* __restrict__ decay,
                 float* __restrict__ hout, int H, int N, int P, int nc, int per_head) {
  using Vec = typename std::conditional<W == 4, float4, float>::type;
  constexpr int DEPTH = 8;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * W;  // first of the W values
  if (e >= N * P) return;
  const int hi = blockIdx.y, bi = blockIdx.z, nl = per_head ? 1 : N;
  const int r = per_head ? 0 : e / P;
  const long long bh = (long long)bi * H + hi, step = (long long)N * P / W;
  Vec* st = reinterpret_cast<Vec*>(state + bh * nc * N * P + e);
  const float* dc = decay + bh * nc * nl + r;
  float h[W];
#pragma unroll
  for (int w = 0; w < W; ++w) h[w] = 0.f;
  for (int k0 = 0; k0 < nc; k0 += DEPTH) {
    Vec local[DEPTH];
    float dec[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      if (k0 + j < nc) {
        local[j] = st[(k0 + j) * step];
        dec[j] = dc[(long long)(k0 + j) * nl];
      }
    }
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      if (k0 + j >= nc) break;
      const float* lv = reinterpret_cast<const float*>(&local[j]);
      Vec out;
      float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ov[w] = h[w];
        h[w] = fmaf(dec[j], h[w], lv[w]);
      }
      st[(k0 + j) * step] = out;
    }
  }
  float* ho = hout + bh * N * P + e;
#pragma unroll
  for (int w = 0; w < W; ++w) ho[w] = h[w];
}

// Pass 3: y = s x + (c ⊙ exp(L)) h_{k−1} for the chunk's real rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_output_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ c, const float* __restrict__ state, T* __restrict__ y,
                  int S, int H, int N, int P, int C, int per_head, int vec, Strides st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P4 = round4(P), LT = round4(C) + 4, nl = per_head ? 1 : N;
  float* xs = smem;                 // (C, P4)
  float* cT = xs + C * P4;          // (N, LT): c, then c ⊙ exp(L)
  float* bT = cT + N * LT;          // (N, LT): b; then (N, P4): h_{k−1}
  float* sT = bT + N * max(LT, P4); // (C, LT): sT[i][t] = s[t, i]
  float* Ls = sT + C * LT;          // (nl, LT)

  const int k = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z, nc = gridDim.x;
  const int t0 = k * C, len = min(C, S - t0);
  const T* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = a + bi * st.a[0] + hi * st.a[2];
  const T* bb = b + bi * st.b[0] + hi * st.b[2];
  const T* cb = c + bi * st.c[0] + hi * st.c[2];

  // h_{k−1} is read into registers now, so that its load overlaps the work on
  // s, and stored where bT was once s is built
  const float4* hin = reinterpret_cast<const float4*>(
      state + (((long long)bi * H + hi) * nc + k) * N * P);
  constexpr int HV = 4;  // float4s of h a thread holds: N·P up to 4096
  const bool h_in_regs = P % 4 == 0 && N * P <= 4 * HV * THREADS;
  float4 hreg[HV];
  if (h_in_regs) {
#pragma unroll
    for (int u = 0; u < HV; ++u) {
      const int q = threadIdx.x + u * THREADS;
      if (q < N * P / 4) hreg[u] = hin[q];
    }
  }
  if (Pieces<T>::fits(C, P, vec & 1) && Pieces<T>::fits(C, N, (vec & 6) == 6)) {
    Pieces<T> px, pb, pc;  // three tiles' loads and a's in flight together
    px.fetch(xb, st.x[1], t0, len, C, P, false);
    pb.fetch(bb, st.b[1], t0, len, C, N, true);
    pc.fetch(cb, st.c[1], t0, len, C, N, true);
    load_log_a(Ls, LT, ab, st, t0, len, C, nl);
    px.place(xs, P4, C, P, false);
    pb.place(bT, LT, C, N, true);
    pc.place(cT, LT, C, N, true);
  } else {
    stage<false>(xs, P4, xb, st.x[1], st.x[3], t0, len, C, P, vec & 1);
    stage<true>(bT, LT, bb, st.b[1], st.b[3], t0, len, C, N, vec & 2);
    stage<true>(cT, LT, cb, st.c[1], st.c[3], t0, len, C, N, vec & 4);
    load_log_a(Ls, LT, ab, st, t0, len, C, nl);
  }
  __syncthreads();
  scan_rows(Ls, LT, nl, C);
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // sT[i, t] = s[t, i] for the 4×4 block (i = m0.., t = n0..); 0 where i > t
  for (int m0 = 4 * ty; m0 < C; m0 += TILE)
    for (int n0 = 4 * tx; n0 < C; n0 += TILE) {
      float acc[4][4];
      zero(acc);
      if (m0 <= n0 + 3) {  // some i <= t in the block
        if (per_head) {
          mm4x4(acc, bT, LT, cT, LT, 0, N, m0, n0);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int s_i = m0 + i, t = n0 + j;
              acc[i][j] = (s_i <= t && t < C) ? acc[i][j] * expf(Ls[t] - Ls[s_i]) : 0.f;
            }
        } else {
          for (int n = 0; n < N; ++n) {
            const float4 bv = *reinterpret_cast<const float4*>(bT + n * LT + m0);
            const float4 li = *reinterpret_cast<const float4*>(Ls + n * LT + m0);
            const float4 cv = *reinterpret_cast<const float4*>(cT + n * LT + n0);
            const float4 lt = *reinterpret_cast<const float4*>(Ls + n * LT + n0);
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w}, li4[4] = {li.x, li.y, li.z, li.w};
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w}, lt4[4] = {lt.x, lt.y, lt.z, lt.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (m0 + i <= n0 + j) acc[i][j] += c4[j] * expf(lt4[j] - li4[i]) * b4[i];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (m0 + i > n0 + j || n0 + j >= C) acc[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m0 + i < C)
          *reinterpret_cast<float4*>(sT + (m0 + i) * LT + n0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  __syncthreads();  // every reader of bT and cT is done

  if (!per_head) {  // c ⊙ exp(L); a per-head decay scales the rows of c·h below
    for (int q = threadIdx.x; q < N * C; q += THREADS) {
      const int n = q / C, t = q % C;
      cT[n * LT + t] *= expf(Ls[n * LT + t]);
    }
  }
  float* hs = bT;  // (N, P4)
  if (h_in_regs) {  // rows of P4 = P floats: the 16-byte pieces in order
#pragma unroll
    for (int u = 0; u < HV; ++u) {
      const int q = threadIdx.x + u * THREADS;
      if (q < N * P / 4) reinterpret_cast<float4*>(hs)[q] = hreg[u];
    }
  } else {
    const float* h = reinterpret_cast<const float*>(hin);
    for (int q = threadIdx.x; q < N * P; q += THREADS) hs[(q / P) * P4 + q % P] = h[q];
  }
  __syncthreads();

  T* yb = y + ((long long)bi * S * H + hi) * P;  // y is contiguous (B, S, H, P)
  const long long y_row = (long long)H * P;
  for (int m0 = 4 * ty; m0 < C; m0 += TILE)
    for (int n0 = 4 * tx; n0 < P; n0 += TILE) {
      float acc[4][4];
      zero(acc);
      mm4x4(acc, cT, LT, hs, P4, 0, N, m0, n0);
      if (per_head) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = m0 + i < C ? expf(Ls[m0 + i]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= w;
        }
      }
      mm4x4(acc, sT, LT, xs, P4, 0, min(C, m0 + 4), m0, n0);  // s[t, i] = 0 for i > t
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + i >= len) break;
        T* o = yb + (t0 + m0 + i) * y_row + n0;
        if (P % 4 == 0) {
          store4(o, acc[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < P) store_f(o + j, acc[i][j]);
        }
      }
    }
}

// Whether every row of `width` elements of a (B,S,H,width) input starts on
// 16 bytes and is contiguous, so that stage() may move 16 bytes at a time.
bool rows_16b(const void* p, const long long (&st)[4], int width, size_t elem) {
  const long long v = 16 / static_cast<long long>(elem);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[3] == 1 && width % v == 0 &&
         st[0] % v == 0 && st[1] % v == 0 && st[2] % v == 0;
}

// Dynamic shared memory of a block of the state pass and of the output
// pass (kernels/ssm_scan.py: shared_memory_bytes).
size_t state_smem(int N, int P, int C, int per_head) {
  return sizeof(float) * ((size_t)C * round4(P) + (size_t)C * round4(N) +
                          (size_t)(per_head ? 1 : N) * (round4(C) + 4));
}

size_t output_smem(int N, int P, int C, int per_head) {
  const size_t LT = round4(C) + 4, P4 = round4(P);
  return sizeof(float) * ((size_t)C * P4 + (size_t)N * LT + (size_t)N * (LT > P4 ? LT : P4) +
                          (size_t)C * LT + (size_t)(per_head ? 1 : N) * LT);
}

template <typename T>
int launch(const void* x, const float* a, const void* b, const void* c, void* y, float* hout,
           float* state, float* decay, int per_head, int B, int S, int H, int N, int P, int C,
           const Strides& st, cudaStream_t stream) {
  const int nc = (S + C - 1) / C;
  const size_t smem1 = state_smem(N, P, C, per_head), smem3 = output_smem(N, P, C, per_head);
  cudaError_t err = cudaFuncSetAttribute(ssm_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  // a refusal is also the runtime's last error: clear it, or the next
  // launch's cudaGetLastError would report it
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(ssm_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(nc, H, B);
  const int vec = int(rows_16b(x, st.x, P, sizeof(T))) | int(rows_16b(b, st.b, N, sizeof(T))) << 1 |
                  int(rows_16b(c, st.c, N, sizeof(T))) << 2;
  ssm_state_kernel<T><<<grid, THREADS, smem1, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), state, decay, S, H, N, P, C,
      per_head, vec, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P % 4 == 0)
    ssm_carry_kernel<4><<<dim3((N * P / 4 + THREADS - 1) / THREADS, H, B), THREADS, 0, stream>>>(
        state, decay, hout, H, N, P, nc, per_head);
  else
    ssm_carry_kernel<1><<<dim3((N * P + THREADS - 1) / THREADS, H, B), THREADS, 0, stream>>>(
        state, decay, hout, H, N, P, nc, per_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_output_kernel<T><<<grid, THREADS, smem3, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), static_cast<const T*>(c), state,
      static_cast<T*>(y), S, H, N, P, C, per_head, vec, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c and y are fp32 when `bf16` is 0 and bf16 when it is 1; a is read
// per channel, or at n = 0 when `per_head` is 1; `strides` (host memory)
// holds the 16 element strides of x, a, b and c, four each; y (B,S,H,P),
// hout (B,H,N,P), the state scratch (B,H,chunks,N,P) and the decay scratch
// (B,H,chunks,per_head ? 1 : N) are contiguous, chunks = ceil(S / C) with
// C = min(chunk, S). Returns a cudaError_t.
extern "C" int ssm_scan_fwd(const void* x, const float* a, const void* b, const void* c,
                            void* y, float* hout, float* state, float* decay, int bf16,
                            int per_head, int B, int S, int H, int N, int P, int chunk,
                            const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || P < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int d = 0; d < 4; ++d) {
    st.x[d] = strides[d];
    st.a[d] = strides[4 + d];
    st.b[d] = strides[8 + d];
    st.c[d] = strides[12 + d];
  }
  const int C = chunk < S ? chunk : S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, a, b, c, y, hout, state, decay, per_head, B, S, H, N, P, C,
                                 st, s);
  return launch<float>(x, a, b, c, y, hout, state, decay, per_head, B, S, H, N, P, C, st, s);
}

// The dynamic shared memory a block of the state pass (`pass` 0) or of the
// output pass (`pass` 1) takes, in bytes, with C = min(chunk, S).
extern "C" long long ssm_scan_smem(int N, int P, int C, int per_head, int pass) {
  return static_cast<long long>(pass ? output_smem(N, P, C, per_head)
                                     : state_smem(N, P, C, per_head));
}
