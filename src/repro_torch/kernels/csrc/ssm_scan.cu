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
// either (B,S,H,N) per channel (RWKV-6) or (B,S,H) per head (Mamba2, passed
// with a zero stride over N). It returns y in x's type and the final state
// in fp32. In chunks of C tokens, in log space, with L_t = Σ_{i≤t} log a_i:
//   s[t,i]  = Σ_n c[t,n] exp(L[t,n] − L[i,n]) b[i,n]   for i ≤ t, else 0
//   y       = s x + (c ⊙ exp(L)) h
//   h      ← exp(L_last) ⊙ h + (b ⊙ exp(L_last − L))ᵀ x
// Every exponent is ≤ 0: nothing overflows, and nothing divides by a
// cumulative decay that may have underflowed (a = 1e-6 stays exact).
//
// Design. One block per (b, h), 256 threads, with a loop over the chunks
// inside the block: that loop takes the place of the TPU grid's sequential
// chunk axis, and the (N, P) state stays in shared memory from one chunk to
// the next. Nothing crosses blocks. Each chunk loads x, log a, b and c into
// shared memory straight from the (B,S,H,·) layout by strides (the row of N
// or P values of one token and head is contiguous, so loads coalesce and no
// fold copy is made), takes the running sum of log a with one thread per
// channel, builds s, folds the decays into c and b, writes y, and updates
// the state. A ragged last chunk reads a = 1, b = c = x = 0 past the end,
// which is what the TPU wrapper's padding does. The (C, N) tiles have rows
// of N + 1 floats, so a warp that walks i over rows of L and b hits 32
// banks. All arithmetic is fp32 on the CUDA cores. Shared memory is
// (C·P + 3·C·(N+1) + C·C + N·P)·4 bytes: 99,072 at C = N = P = 64, so it is
// dynamic, above the 48 KB static limit.
//
// What bounds it on this card. The recurrence itself needs about 5·N·P
// flops a token and head, and the inputs and outputs are read and written
// once: at B=1, S=1024, H=32, N=P=64 with bf16 x/b/c/y, 0.67 GFLOP at the
// 67 TFLOP/s fp32 rate (10 µs) against 25.7 MB at 3.35 TB/s (7.7 µs), so
// operations bound it. The chunked form does more: the C·C·N/2 exponentials
// of s dominate. This simple design also leaves the card mostly idle at
// B=1: 32 heads are 32 blocks for 132 SMs, one block and eight warps each.
// Splitting the work of a head over more blocks, keeping s out of
// exponentials by tensor-core products, and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

// Element strides of the (B, S, H, last) dims of each input.
struct Strides {
  long long x[4], a[4], b[4], c[4];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ y,
                      float* __restrict__ hout, int S, int H, int N, int P, int C,
                      Strides st) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* xs = smem;          // (C, P)
  float* Ls = xs + C * P;    // (C, ld): log a, then its running sum L
  float* bs = Ls + C * ld;   // (C, ld): b, then b ⊙ exp(L_last − L)
  float* cs = bs + C * ld;   // (C, ld): c, then c ⊙ exp(L)
  float* ss = cs + C * ld;   // (C, C): the masked intra-chunk weights s
  float* hs = ss + C * C;    // (N, P): the state

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H;
  const int tid = threadIdx.x;
  const T* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = a + bi * st.a[0] + hi * st.a[2];
  const T* bb = b + bi * st.b[0] + hi * st.b[2];
  const T* cb = c + bi * st.c[0] + hi * st.c[2];
  T* yb = y + ((long long)bi * S * H + hi) * P;  // y is contiguous (B, S, H, P)
  const long long y_row = (long long)H * P;

  for (int q = tid; q < N * P; q += THREADS) hs[q] = 0.f;

  for (int t0 = 0; t0 < S; t0 += C) {
    const int len = min(C, S - t0);

    // 1. load the chunk; rows past the end read as a = 1, b = c = x = 0
    for (int q = tid; q < C * P; q += THREADS) {
      const int t = q / P, p = q % P;
      xs[q] = t < len ? load_f(xb + (t0 + t) * st.x[1] + p * st.x[3]) : 0.f;
    }
    for (int q = tid; q < C * N; q += THREADS) {
      const int t = q / N, n = q % N;
      float la = 0.f, bv = 0.f, cv = 0.f;
      if (t < len) {
        const long long ts = t0 + t;
        la = logf(fmaxf(ab[ts * st.a[1] + n * st.a[3]], 1e-37f));
        bv = load_f(bb + ts * st.b[1] + n * st.b[3]);
        cv = load_f(cb + ts * st.c[1] + n * st.c[3]);
      }
      Ls[t * ld + n] = la;
      bs[t * ld + n] = bv;
      cs[t * ld + n] = cv;
    }
    __syncthreads();

    // 2. L = running sum of log a over the chunk, one thread per channel
    for (int n = tid; n < N; n += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += Ls[t * ld + n];
        Ls[t * ld + n] = acc;
      }
    }
    __syncthreads();

    // 3. s[t, i] = Σ_n c[t, n] exp(L[t, n] − L[i, n]) b[i, n] for i ≤ t
    for (int q = tid; q < C * C; q += THREADS) {
      const int t = q / C, i = q % C;
      float acc = 0.f;
      if (i <= t) {
        const float* Lt = Ls + t * ld;
        const float* Li = Ls + i * ld;
        const float* ct = cs + t * ld;
        const float* bi_row = bs + i * ld;
        for (int n = 0; n < N; ++n) acc += ct[n] * expf(Lt[n] - Li[n]) * bi_row[n];
      }
      ss[q] = acc;
    }
    __syncthreads();

    // 4. fold the decays in: c ⊙ exp(L) and b ⊙ exp(L_last − L), both ≤ 1
    for (int q = tid; q < C * N; q += THREADS) {
      const int t = q / N, n = q % N;
      const float L = Ls[t * ld + n];
      cs[t * ld + n] *= expf(L);
      bs[t * ld + n] *= expf(Ls[(C - 1) * ld + n] - L);
    }
    __syncthreads();

    // 5. y = s x + (c ⊙ exp(L)) h for the chunk's real rows
    for (int q = tid; q < C * P; q += THREADS) {
      const int t = q / P, p = q % P;
      if (t < len) {
        float acc = 0.f;
        for (int i = 0; i <= t; ++i) acc += ss[t * C + i] * xs[i * P + p];
        for (int n = 0; n < N; ++n) acc += cs[t * ld + n] * hs[n * P + p];
        store_f(yb + (t0 + t) * y_row + p, acc);
      }
    }
    __syncthreads();

    // 6. h = exp(L_last) ⊙ h + (b ⊙ exp(L_last − L))ᵀ x
    for (int q = tid; q < N * P; q += THREADS) {
      const int n = q / P, p = q % P;
      float acc = expf(Ls[(C - 1) * ld + n]) * hs[q];
      for (int t = 0; t < C; ++t) acc += bs[t * ld + n] * xs[t * P + p];
      hs[q] = acc;
    }
    __syncthreads();
  }

  float* ho = hout + (long long)bh * N * P;
  for (int q = tid; q < N * P; q += THREADS) ho[q] = hs[q];
}

template <typename T>
int launch(const void* x, const float* a, const void* b, const void* c, void* y, float* hout,
           int B, int S, int H, int N, int P, int C, const Strides& st, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)C * P + 3 * (size_t)C * (N + 1) + (size_t)C * C + (size_t)N * P);
  cudaError_t err = cudaFuncSetAttribute(ssm_chunk_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_chunk_scan_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(y), hout, S, H, N, P, C, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c and y are fp32 when `bf16` is 0 and bf16 when it is 1; `strides`
// (host memory) holds the 16 element strides of x, a, b and c, four each;
// y (B,S,H,P) and hout (B,H,N,P) are contiguous. Returns a cudaError_t.
extern "C" int ssm_scan_fwd(const void* x, const float* a, const void* b, const void* c,
                            void* y, float* hout, int bf16, int B, int S, int H, int N, int P,
                            int chunk, const long long* strides, void* stream) {
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
  if (bf16) return launch<__nv_bfloat16>(x, a, b, c, y, hout, B, S, H, N, P, C, st, s);
  return launch<float>(x, a, b, c, y, hout, B, S, H, N, P, C, st, s);
}
