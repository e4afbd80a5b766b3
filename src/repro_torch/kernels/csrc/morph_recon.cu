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
// Design. One launch is one call of `morph_recon_sweep`. Each block owns a
// TILE x TILE output tile, one thread per pixel. It loads the tile with a
// one-pixel halo of m (each value clamped by its own mask value, which makes
// the first launch compute min(marker, mask) itself) into shared memory and
// keeps the tile's mask in registers. It then runs dilate-min sweeps in
// shared memory until the tile stops changing (__syncthreads_or) or
// `max_inner` sweeps have run, writes the interior to the output buffer,
// and sets the device flag if any pixel differs from what it read. The
// halo stays as it was at launch start: a wavefront crosses a tile edge on
// the next launch. The host drives launches over two ping-pong buffers,
// reading the 4-byte flag once per launch, until a launch changes nothing.
//
// Why the result is exact: only fmaxf and fminf touch the values. Every
// update is monotone and stays below the reconstruction r (r is a fixpoint
// of the same update), and a launch that changes nothing proves the whole
// image is a fixpoint at least the marker, so it equals r. The order of the
// updates, the tile size and the sweep cap change the number of launches,
// never the result.
//
// What bounds it on this card: memory traffic (marker or m and mask read,
// m written: 12 bytes a pixel a launch) times the data-dependent number of
// launches, which grows with the longest geodesic path over TILE. Launches
// after the first also re-run tiles that have already settled; skipping
// them is work for a later change.
//
// NaN is outside the contract: fmaxf/fminf drop a NaN operand, where
// torch.maximum propagates it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = TILE + 2;

template <int CONN>
__global__ void __launch_bounds__(TILE * TILE)
recon_sweep_kernel(const float* __restrict__ m_in, const float* __restrict__ mask,
                   float* __restrict__ m_out, int* __restrict__ changed, int h, int w,
                   int max_inner) {
  __shared__ float s[HALO][HALO];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;

  for (int i = ty * TILE + tx; i < HALO * HALO; i += TILE * TILE) {
    const int gy = y0 + i / HALO - 1, gx = x0 + i % HALO - 1;
    float v = -INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const long long p = (long long)gy * w + gx;
      v = fminf(m_in[p], mask[p]);
    }
    s[i / HALO][i % HALO] = v;
  }

  const int gy = y0 + ty, gx = x0 + tx;
  const bool inside = gy < h && gx < w;
  const long long p = (long long)gy * w + gx;
  const float read = inside ? m_in[p] : -INFINITY;
  const float mk = inside ? mask[p] : -INFINITY;
  __syncthreads();

  float v = s[ty + 1][tx + 1];
  for (int it = 0; it < max_inner; ++it) {
    float d = fmaxf(v, s[ty][tx + 1]);
    d = fmaxf(d, s[ty + 2][tx + 1]);
    d = fmaxf(d, s[ty + 1][tx]);
    d = fmaxf(d, s[ty + 1][tx + 2]);
    if (CONN == 8) {
      d = fmaxf(d, s[ty][tx]);
      d = fmaxf(d, s[ty][tx + 2]);
      d = fmaxf(d, s[ty + 2][tx]);
      d = fmaxf(d, s[ty + 2][tx + 2]);
    }
    const float nv = fminf(d, mk);
    const int moved = nv != v;
    __syncthreads();  // every read of this sweep is done before any write
    s[ty + 1][tx + 1] = nv;
    v = nv;
    if (!__syncthreads_or(moved)) break;
  }

  if (inside) m_out[p] = v;
  if (__syncthreads_or(inside && v != read) && tx == 0 && ty == 0) *changed = 1;
}

}  // namespace

// One launch: zero `changed`, run every tile's sweeps from m_in into m_out.
// m_in may be the marker (first launch) or the previous launch's output;
// m_out must not alias m_in or mask. Returns the CUDA error code (0 = ok).
extern "C" int morph_recon_sweep(const float* m_in, const float* mask, float* m_out,
                                 int* changed, int h, int w, int conn, int max_inner,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TILE, TILE);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  if (conn == 4) {
    recon_sweep_kernel<4><<<grid, block, 0, st>>>(m_in, mask, m_out, changed, h, w, max_inner);
  } else if (conn == 8) {
    recon_sweep_kernel<8><<<grid, block, 0, st>>>(m_in, mask, m_out, changed, h, w, max_inner);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
