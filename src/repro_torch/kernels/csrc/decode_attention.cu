// Decode attention for Hopper (sm_90a): one query token against a KV cache,
// the card's route of decode_attention in src/repro_torch/models/attention.py.
//
// It replaces no Pallas kernel: the JAX package computes decode attention
// as two plain jnp.einsum's around a softmax (src/repro/models/attention.py,
// decode_attention), which XLA fuses on the TPU. It was added because the
// port's plain route, run on the card, upcast each cache to fp32 (.float()
// writes a copy of it), the einsums copied that again into their layout,
// and a batched GEMV then read it: at Zamba2-7B's decode shape (B 8, S 3648,
// 32 kv heads, D 224, bf16) about 8 GB moved a call where the cache is
// 0.84 GB, some 58 ms of an 86 ms decode step over its 13 calls.
//
// What it computes, as the plain route does, with rep = H / KV q heads on
// each kv head and the valid span [lo, cur) = [max(0, cur - window), cur):
//   q' = q * q_scale in fp32, rounded to bf16 where round_q (the JAX
//        package's product, q times 1/sqrt(D) in q's dtype), else fp32;
//   l_s = q' . k_s, summed in fp32, for s in the span;
//   p_s = bf16(exp(l_s - max l) / sum exp(l - max l));
//   out = bf16(sum_s p_s * v_s), summed in fp32.
// q, the caches and the output are bf16: every path's cache is allocated in
// the models' compute dtype (bf16) and its q is a bf16 product. Only the
// order of the sums differs from the plain route. `cur` is a host value or
// a 0-d int64 on the card (a CUDA graph replays a decode step at a new
// position); a `cur` outside [1, S] gives NaN rather than a silent answer,
// since the host cannot check it.
//
// What bounds it on this card: bytes. K and V are read once, in bf16:
// 2 * B * L * KV * D * 2 bytes for the span's L positions;
// at Zamba2-7B's shape 837 MB, 0.250 ms at 3.35 TB/s. The rest -- fp32
// logits (B * H * L * 4 bytes, written once and read once, from L2), the
// per-split maxima and sums, and the per-split partial outputs -- is under
// 1% of that there.
//
// Design: three launches on the caller's stream; none waits for the host,
// and the wrapper allocates all scratch, so that a CUDA graph can capture
// the call.
//   1. logits_pass: a block a (split of the span, kv head, batch row). Its
//      warps stream the split's K rows with 16-byte loads (8 elements a
//      lane: D / 8 neighbouring lanes a row, so several rows a warp where D
//      is small), UNROLL rows a lane in flight. Each row is read once and
//      dotted with the q' of every q head of its group (held in
//      registers), so grouped-query attention reads the cache once. The
//      first lane of each row writes the fp32 logits and keeps a running
//      maximum and sum of exponentials; the block writes them a split.
//   2. values_pass: the same blocks over V. Each first merges the splits'
//      maxima and sums into the row's global maximum m and sum z, then
//      forms p = bf16(exp(l - m) / z) for each row it reads and adds p * v
//      into fp32 registers; the block sums its warps in a fixed order and
//      writes one fp32 partial output a split.
//   3. combine_pass: a block a (q head, batch row) sums the splits' partial
//      outputs in order, rounds once to bf16, and adds the call to a count
//      on the card. Every sum has a fixed order, so a call repeats bit for
//      bit.
// Blocks whose split lies past the span's end read nothing. The splits
// (chosen by the wrapper from B * KV and the span's largest length) fill
// the card's resident block slots about once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ELEMS = 8;             // elements of a row a lane reads
constexpr int UNROLL = 4;            // rows a lane has in flight
constexpr int MAX_D = 32 * ELEMS;    // a row spans at most one warp
constexpr float NEG = -1e30f;        // the plain route's masked logit

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight neighbouring bf16 elements of a cache row, loaded in 16 bytes.
struct Chunk {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&f)[ELEMS]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct Span {
  int lo, len;  // len 0: `cur` outside [1, S]
};

__device__ __forceinline__ Span span_of(const long long* cur_dev, long long cur_host,
                                        long long window, int s) {
  const long long cur = cur_dev ? *cur_dev : cur_host;
  if (cur < 1 || cur > s) return {0, 0};
  const long long lo = cur > window ? cur - window : 0;
  return {static_cast<int>(lo), static_cast<int>(cur - lo)};
}

// (m, z) <- the maximum and the sum of exponentials of both sets, z
// relative to the maximum; (NEG, 0) is the empty set.
__device__ __forceinline__ void merge(float& m, float& z, float m2, float z2) {
  const float mm = fmaxf(m, m2);
  z = z * expf(m - mm) + z2 * expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void warp_merge(float& m, float& z) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, z, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, z, o));
}

// The sum of x over the `lanes` lanes of a row, in the row's first lane
// (c is the lane's place in its row; a row's lanes are contiguous).
__device__ __forceinline__ float row_sum(float x, int c, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, o);
    if (c + o < lanes) x += y;
  }
  return x;
}

struct Args {
  const __nv_bfloat16* q;
  int round_q;
  float q_scale;
  const __nv_bfloat16* cache;  // K in the logits pass, V in the values pass
  long long sb, ss, sh;        // its element strides: batch, position, head
  int s, heads, kv_heads, rep, d;
  const long long* cur_dev;    // null: cur_host
  long long cur_host, window;
  int nsplit, rows, lmax;      // splits, rows a split, logits a (b, h)
  float* logits;               // (B, H, lmax), by place in the span
  float2* stats;               // (B, H, nsplit): each split's (max, sum)
  float* partial;              // (B, H, nsplit, D)
};

// Where a block's lane stands: its row in the warp (seg) and its place in
// that row (c); lanes past the warp's last whole row take no row.
struct Lane {
  int lanes, rpw, lane, warp, seg, c;
  bool on;
  __device__ __forceinline__ explicit Lane(int d) {
    lanes = d / ELEMS;
    rpw = 32 / lanes;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    seg = lane / lanes;
    c = lane - seg * lanes;
    on = seg < rpw;
  }
};

template <int MAXREP>
__global__ void __launch_bounds__(THREADS) logits_pass(Args a) {
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const Span sp = span_of(a.cur_dev, a.cur_host, a.window, a.s);
  const int r0 = split * a.rows;
  if (r0 >= sp.len) return;
  const int r1 = min(r0 + a.rows, sp.len);
  const Lane ln(a.d);
  const int h0 = g * a.rep;

  float qr[MAXREP][ELEMS];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      float x = 0.f;
      if (ln.on && r < a.rep) {
        const long long i = (static_cast<long long>(b) * a.heads + h0 + r) * a.d + ln.c * ELEMS + e;
        x = __bfloat162float(a.q[i]) * a.q_scale;
        if (a.round_q) x = bf16_round(x);
      }
      qr[r][e] = x;
    }

  float m[MAXREP], z[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) m[r] = NEG, z[r] = 0.f;
  const __nv_bfloat16* base = a.cache + b * a.sb + g * a.sh + sp.lo * a.ss + ln.c * ELEMS;
  float* lg = a.logits + (static_cast<long long>(b) * a.heads + h0) * a.lmax;
  const int step = WARPS * ln.rpw;
  for (int row0 = r0 + ln.warp * ln.rpw; row0 < r1; row0 += UNROLL * step) {
    Chunk ch[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = row0 + u * step + ln.seg;
      if (ln.on && row < r1) ch[u].load(base + row * a.ss);
      else ch[u].zero();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = row0 + u * step + ln.seg;
      float kf[ELEMS];
      ch[u].get(kf);
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= a.rep) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        dot = row_sum(dot, ln.c, ln.lanes);
        if (ln.on && ln.c == 0 && row < r1) {
          lg[static_cast<long long>(r) * a.lmax + row] = dot;
          if (dot > m[r]) {
            z[r] = z[r] * expf(m[r] - dot) + 1.f;
            m[r] = dot;
          } else {
            z[r] += expf(dot - m[r]);
          }
        }
      }
    }
  }

  __shared__ float sm_m[WARPS][MAXREP], sm_z[WARPS][MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= a.rep) break;
    warp_merge(m[r], z[r]);  // lanes that took no row hold (NEG, 0)
    if (ln.lane == 0) sm_m[ln.warp][r] = m[r], sm_z[ln.warp][r] = z[r];
  }
  __syncthreads();
  if (threadIdx.x < a.rep) {
    const int r = threadIdx.x;
    float mm = NEG, zz = 0.f;
    for (int w = 0; w < WARPS; ++w) merge(mm, zz, sm_m[w][r], sm_z[w][r]);
    a.stats[(static_cast<long long>(b) * a.heads + h0 + r) * a.nsplit + split] = make_float2(mm, zz);
  }
}

template <int MAXREP>
__global__ void __launch_bounds__(THREADS) values_pass(Args a) {
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const Span sp = span_of(a.cur_dev, a.cur_host, a.window, a.s);
  const int r0 = split * a.rows;
  if (r0 >= sp.len) return;
  const int r1 = min(r0 + a.rows, sp.len);
  const Lane ln(a.d);
  const int h0 = g * a.rep;

  // each q head's maximum and sum over the span: warp r merges head r's splits
  __shared__ float sm_m[MAXREP], sm_z[MAXREP];
  __shared__ float sm_acc[MAXREP * MAX_D];
  const int used = (sp.len + a.rows - 1) / a.rows;
  if (ln.warp < a.rep) {
    const float2* st = a.stats + (static_cast<long long>(b) * a.heads + h0 + ln.warp) * a.nsplit;
    float mm = NEG, zz = 0.f;
    for (int j = ln.lane; j < used; j += 32) merge(mm, zz, st[j].x, st[j].y);
    warp_merge(mm, zz);
    if (ln.lane == 0) sm_m[ln.warp] = mm, sm_z[ln.warp] = zz;
  }
  __syncthreads();
  float mx[MAXREP], zs[MAXREP], acc[MAXREP][ELEMS];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    mx[r] = r < a.rep ? sm_m[r] : 0.f;
    zs[r] = r < a.rep ? sm_z[r] : 1.f;
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) acc[r][e] = 0.f;
  }

  const __nv_bfloat16* base = a.cache + b * a.sb + g * a.sh + sp.lo * a.ss + ln.c * ELEMS;
  const float* lg = a.logits + (static_cast<long long>(b) * a.heads + h0) * a.lmax;
  const int step = WARPS * ln.rpw;
  for (int row0 = r0 + ln.warp * ln.rpw; row0 < r1; row0 += UNROLL * step) {
    Chunk ch[UNROLL];
    float l[UNROLL][MAXREP];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = row0 + u * step + ln.seg;
      const bool in = ln.on && row < r1;
      if (in) ch[u].load(base + row * a.ss);
      else ch[u].zero();
#pragma unroll
      for (int r = 0; r < MAXREP; ++r)
        l[u][r] = in && r < a.rep ? lg[static_cast<long long>(r) * a.lmax + row] : NEG;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = ln.on && row0 + u * step + ln.seg < r1;
      float vf[ELEMS];
      ch[u].get(vf);
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= a.rep) break;
        const float p = in ? bf16_round(expf(l[u][r] - mx[r]) / zs[r]) : 0.f;
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // the warp's rows into its first row's lanes, pairwise in a fixed order
  for (int o = 1; o < ln.rpw; o <<= 1) {
    const bool take = ln.seg % (2 * o) == 0 && ln.seg + o < ln.rpw;
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= a.rep) break;
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const float y = __shfl_down_sync(0xffffffffu, acc[r][e], o * ln.lanes);
        if (take) acc[r][e] += y;
      }
    }
  }
  // the warps in order
  for (int w = 0; w < WARPS; ++w) {
    if (ln.warp == w && ln.seg == 0) {
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= a.rep) break;
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) {
          float* s = &sm_acc[r * a.d + ln.c * ELEMS + e];
          *s = w == 0 ? acc[r][e] : *s + acc[r][e];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < a.rep * a.d; i += THREADS) {
    const int r = i / a.d, x = i - r * a.d;
    a.partial[((static_cast<long long>(b) * a.heads + h0 + r) * a.nsplit + split) * a.d + x] =
        sm_acc[i];
  }
}

struct CombineArgs {
  const float* partial;
  __nv_bfloat16* out;
  int s, heads, d, nsplit, rows;
  const long long* cur_dev;
  long long cur_host, window;
  unsigned long long* calls;
};

__global__ void __launch_bounds__(THREADS) combine_pass(CombineArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const Span sp = span_of(a.cur_dev, a.cur_host, a.window, a.s);
  const int used = (sp.len + a.rows - 1) / a.rows;
  const long long row = static_cast<long long>(b) * a.heads + h;
  const float* p = a.partial + row * a.nsplit * a.d;
  for (int x = threadIdx.x; x < a.d; x += THREADS) {
    float sum = 0.f;
    for (int j = 0; j < used; ++j) sum += p[static_cast<long long>(j) * a.d + x];
    // NaN: no valid span
    a.out[row * a.d + x] = __float2bfloat16_rn(used ? sum : __int_as_float(0x7fc00000));
  }
  if (h == 0 && b == 0 && threadIdx.x == 0) atomicAdd(a.calls, 1ull);
}

template <int MAXREP>
cudaError_t occupancy(int* blocks) {
  int k = 0, v = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, logits_pass<MAXREP>,
                                                                  THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, values_pass<MAXREP>, THREADS, 0);
  *blocks = k < v ? k : v;
  return err;
}

template <int MAXREP>
cudaError_t run(const Args& k_args, const Args& v_args, const CombineArgs& c, int b,
                cudaStream_t stream) {
  const dim3 grid(k_args.nsplit, k_args.kv_heads, b);
  logits_pass<MAXREP><<<grid, THREADS, 0, stream>>>(k_args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  values_pass<MAXREP><<<grid, THREADS, 0, stream>>>(v_args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_pass<<<dim3(c.heads, b), THREADS, 0, stream>>>(c);
  return cudaGetLastError();
}

int max_rep_of(int rep) { return rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8; }

}  // namespace

// The fewest blocks of the logits and values passes that can be resident
// at once on one SM of the current device, for `rep` q heads a kv head.
extern "C" int decode_attention_blocks_per_sm(int rep, int* blocks) {
  *blocks = 0;
  if (rep < 1 || rep > 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (max_rep_of(rep)) {
    case 1: return static_cast<int>(occupancy<1>(blocks));
    case 2: return static_cast<int>(occupancy<2>(blocks));
    case 4: return static_cast<int>(occupancy<4>(blocks));
    default: return static_cast<int>(occupancy<8>(blocks));
  }
}

// Scratch floats a call needs: per-split (max, sum) pairs, partial outputs
// and the logits.
extern "C" long long decode_attention_scratch(int b, int s, int heads, int d, long long window,
                                              int nsplit) {
  const long long bh = static_cast<long long>(b) * heads;
  const long long lmax = window < s ? window : s;
  return bh * nsplit * (2 + d) + bh * lmax;
}

// One call, all of it bf16 but the scratch. q: (B, 1, H, D) contiguous. k,
// v: (B, S, KV, D), with element strides ks, vs (batch, position, head; the
// last dim contiguous) that keep every row on 16 bytes. cur: *cur_dev where
// cur_dev is not null, else cur_host. The span's largest length,
// min(S, window), is covered by nsplit splits of `rows` rows. out: (B, 1,
// H, D) contiguous. scratch: decode_attention_scratch(...) floats, 8-byte
// aligned, any content; calls: one uint64 on the card that each call adds
// 1 to. Returns the CUDA error code (0 = ok).
extern "C" int decode_attention(const void* q, float q_scale, int round_q, const void* k,
                                const long long* ks, const void* v, const long long* vs, int b,
                                int s, int heads, int kv_heads, int d, const long long* cur_dev,
                                long long cur_host, long long window, int nsplit, int rows,
                                void* out, float* scratch, unsigned long long* calls,
                                void* stream) {
  if (b <= 0 || s <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > 8 || d % ELEMS != 0 || d < ELEMS || d > MAX_D || window < 1 ||
      nsplit < 1 || rows < 1 || static_cast<long long>(nsplit) * rows < (window < s ? window : s) ||
      kv_heads > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args ka{};
  ka.q = static_cast<const __nv_bfloat16*>(q);
  ka.round_q = round_q;
  ka.q_scale = q_scale;
  ka.cache = static_cast<const __nv_bfloat16*>(k);
  ka.sb = ks[0], ka.ss = ks[1], ka.sh = ks[2];
  ka.s = s, ka.heads = heads, ka.kv_heads = kv_heads, ka.rep = heads / kv_heads, ka.d = d;
  ka.cur_dev = cur_dev, ka.cur_host = cur_host, ka.window = window;
  ka.nsplit = nsplit, ka.rows = rows, ka.lmax = static_cast<int>(window < s ? window : s);
  const long long bh = static_cast<long long>(b) * heads;
  ka.stats = reinterpret_cast<float2*>(scratch);
  ka.partial = scratch + 2 * bh * nsplit;
  ka.logits = ka.partial + bh * nsplit * d;
  Args va = ka;
  va.cache = static_cast<const __nv_bfloat16*>(v);
  va.sb = vs[0], va.ss = vs[1], va.sh = vs[2];
  const CombineArgs c{ka.partial, static_cast<__nv_bfloat16*>(out), s, heads, d, nsplit, rows,
                      cur_dev, cur_host, window, calls};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (max_rep_of(ka.rep)) {
    case 1: err = run<1>(ka, va, c, b, st); break;
    case 2: err = run<2>(ka, va, c, b, st); break;
    case 4: err = run<4>(ka, va, c, b, st); break;
    default: err = run<8>(ka, va, c, b, st); break;
  }
  return static_cast<int>(err);
}
