// Causal, sliding-window, grouped-query attention forward pass
// (FlashAttention-2's streaming softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// `_fa_kernel` and its wrapper `flash_attention_pallas`.
//
// What it computes, for q (B,Sq,H,D) and k, v (B,Sk,KV,D), all fp32 or all
// bf16, read in place by strides, with query head h reading kv head
// h / (H/KV):
//   s[i,j] = (q_i · scale) · k_j in fp32, scale = 1/sqrt(D),
//   kept where j < Sk, j <= qpos_i when causal, and j > qpos_i − window
//   with a window, qpos_i = i + q_offset; -1e30 elsewhere;
//   out_i  = Σ_j exp(s[i,j] − m_i) v_j / max(Σ_j exp(s[i,j] − m_i), 1e-30)
// with the running max m, sum and accumulator in fp32, written in q's type
// to a contiguous (B,Sq,H,D) output. A key tile that is wholly masked for
// the block's rows is skipped on the TPU kernel's test. A masked logit adds
// exactly 0, which is what exp(-1e30 − m) gives once a row has one key; so
// a row with no key at all comes out 0, as in the dense oracle, whatever
// the tile size.
//
// Design. One block of 256 threads per (batch, head, 64 query rows), the
// longest causal rows launched first; a loop over 64-key tiles inside the
// block takes the place of the TPU grid's sequential k axis, and the fp32
// running max, sum and accumulator stay in registers across it. The block
// stages q·scale, the K tile and the V tile in shared memory as fp32, with
// rows of D|1 floats so that a half-warp walking keys hits distinct banks.
// Threads form a 16×16 grid: thread (ty, tx) owns query rows 4·ty..4·ty+3,
// the key columns tx + 16·c of the logit tile, and the output columns
// tx + 16·c (D/16 of them, rounded up: the template argument). A row's max
// and sum are reduced over the 16 lanes of a half-warp by shuffles, and the
// probabilities go through shared memory into the P·V product. All
// arithmetic is IEEE fp32 on the CUDA cores (no TF32), so fp32 inputs agree
// with the dense oracle to 2e-5. Shared memory is (3·64·(D|1) + 64·65)·4
// bytes, 78,848 at D = 80: dynamic, above the 48 KB static limit, so two
// blocks fit an SM. D goes up to 256 (gemma3's and PaliGemma's head dim):
// 16 output columns a thread, 214,016 bytes of shared memory, one block an
// SM, under the 232,448-byte opt-in. ptxas (-Xptxas -v, for sm_90a)
// gives the 16-column instances 128 registers a thread and no spill; the
// 6- to 15-column ones 127–128 registers and no spill; the 1- and 5-column
// ones (D <= 16 and D = 65..80) a 16-byte stack frame with 24–64 bytes of
// spill stores.
//
// What bounds it on this card. Causal attention needs 4·D flops for each
// (query, key) pair it keeps, per head, and reads q, k, v and writes the
// output once: at B=1, S=4096, H=32, D=80 in bf16 that is 85.9 GFLOP at the
// 989 TFLOP/s bf16 tensor rate (0.087 ms) against 83.9 MB at 3.35 TB/s
// (0.025 ms), so operations bound it, with the 268 M exponentials at the
// SFU rate close behind. This simple design runs its products on the fp32
// CUDA cores, from shared memory, at a small fraction of that:
// tensor-core (wgmma) tiles fed by TMA, and fewer exponentials, are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // a 16×16 grid of threads
constexpr int LDP = BK + 1;   // row length of the probability tile
constexpr int MAX_DPT = 16;   // output columns a thread: D <= 256
constexpr float NEG = -1e30f;

// Element strides of the (B, S, heads, D) dims of q, k and v.
struct Strides {
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Max and sum over the 16 lanes of a half-warp (tx = lane % 16).
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Sq, int Sk, int H, int KV, int D, int causal,
                 int has_window, int window, int q_offset, float scale, Strides st) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* Qs = smem;          // (BQ, ld): q · scale
  float* Ks = Qs + BQ * ld;  // (BK, ld)
  float* Vs = Ks + BK * ld;  // (BK, ld)
  float* Ps = Vs + BK * ld;  // (BQ, LDP): this tile's probabilities

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = iq * BQ;
  const T* qb = q + bi * st.q[0] + hi * st.q[2];
  const T* kb = k + bi * st.k[0] + kvh * st.k[2];
  const T* vb = v + bi * st.v[0] + kvh * st.v[2];

  // rows past Sq read as 0; they are computed and not written
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, row = row0 + r;
    Qs[r * ld + d] = row < Sq ? load_f(qb + row * st.q[1] + d * st.q[3]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // the TPU kernel's tile test, over the block's padded rows
  const int a_lo = row0 + q_offset, a_hi = a_lo + BQ - 1;
  for (int k_lo = 0; k_lo < Sk; k_lo += BK) {
    if (causal && k_lo > a_hi) break;  // and every later tile
    if (has_window && k_lo + BK <= a_lo - window + 1) continue;
    __syncthreads();  // Qs written; the previous tile's readers done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D, key = k_lo + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = load_f(kb + key * st.k[1] + d * st.k[3]);
        vv = load_f(vb + key * st.v[1] + d * st.v[3]);
      }
      Ks[j * ld + d] = kv;
      Vs[j * ld + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + ty * 4 + i + q_offset;
      bool keep[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        keep[c] = kpos < Sk && (!causal || kpos <= qpos) && (!has_window || kpos > qpos - window);
        if (!keep[c]) s[i][c] = NEG;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = keep[c] ? expf(s[i][c] - m_new) : 0.f;
        Ps[(ty * 4 + i) * LDP + tx + 16 * c] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? Vs[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* o = out + ((long long)(bi * Sq + row) * H + hi) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store_f(o + d, acc[i][c] / den);
    }
  }
}

// Dynamic shared memory of a block: the q, K and V tiles and the
// probability tile (kernels/flash_attention.py: shared_memory_bytes).
size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D | 1) + (size_t)BQ * LDP);
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           int KV, int D, int causal, int has_window, int window, int q_offset, float scale,
           const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  // a refusal is also the runtime's last error: clear it, or the next
  // launch's cudaGetLastError would report it
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, D, causal, has_window, window, q_offset, scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dpt, const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int H, int KV, int D, int causal, int has_window, int window, int q_offset,
             float scale, const Strides& st, cudaStream_t s) {
  switch (dpt) {
#define FA_CASE(N) \
  case N:          \
    return launch<T, N>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, has_window, window, \
                        q_offset, scale, st, s);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
    FA_CASE(9) FA_CASE(10) FA_CASE(11) FA_CASE(12) FA_CASE(13) FA_CASE(14) FA_CASE(15)
    FA_CASE(16)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v and out are fp32 when `bf16` is 0 and bf16 when it is 1;
// `strides` (host memory) holds the 12 element strides of q, k and v, four
// each; out (B,Sq,H,D) is contiguous. `window` is read when `has_window` is
// 1; `scale` is 1/sqrt(D), rounded to fp32 by the caller. Returns a
// cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int bf16, int B, int Sq, int Sk, int H, int KV, int D,
                                   int causal, int has_window, int window, int q_offset,
                                   float scale, const long long* strides, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > 16 * MAX_DPT)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int d = 0; d < 4; ++d) {
    st.q[d] = strides[d];
    st.k[d] = strides[4 + d];
    st.v[d] = strides[8 + d];
  }
  const int dpt = (D + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(dpt, q, k, v, out, B, Sq, Sk, H, KV, D, causal, has_window,
                                   window, q_offset, scale, st, s);
  return dispatch<float>(dpt, q, k, v, out, B, Sq, Sk, H, KV, D, causal, has_window, window,
                         q_offset, scale, st, s);
}

// The dynamic shared memory a block takes at head dim D, in bytes.
extern "C" long long flash_attention_smem(int D) { return static_cast<long long>(smem_bytes(D)); }
