// Windowed tile blend, forward and backward, for Hopper (sm_90a), fp32, in
// the padded and the packed layout.
//
// Replaces the Pallas TPU kernels of gsmpm_tpu/render/pallas_blend.py:
//   K4 _blend_kernel + _blend_kernel_streamed (launcher _blend_core)
//        -> gsmpm_blend_fwd
//   K5 _blend_bwd_kernel + _blend_bwd_kernel_streamed (_blend_core_bwd)
//        -> gsmpm_blend_bwd
//   K8 _blend_kernel_packed (_blend_core_packed)  -> gsmpm_blend_packed_fwd
//   K9 _blend_bwd_kernel_packed (_blend_core_packed_bwd)
//        -> gsmpm_blend_packed_bwd
// Plain twins: gsmpm_tpu_torch/render/cuda_blend.py blend_core_ref /
// blend_core_bwd_ref / blend_packed_ref / blend_packed_bwd_ref.  One kernel
// serves every window width K: the TPU's streamed variants exist only
// because of its VMEM limit.  K8 / K9 are K4 / K5 instantiated on the
// packed addressing (template parameter PACKED).
//
// Layouts (the JAX package's):
//   counts (nblocks,) int32: live candidates of each block's window
//   F (nblocks, 16, K): rows 0..5 the quadratic form's coefficients of the
//     block-local pixel monomials [px^2, px, 1, py^2, py, px py], row 6 the
//     log opacity (-1e30 for dead slots), rows 8..10 the colors
//   packed: F (16, T) holds every block's window back to back; block b owns
//     columns [offs[b], offs[b] + n_live*C) with n_live = min(ceil(count_b
//     / C), n_chunks), and its candidate indices (and row 5 of out) are
//     local to that slice.  dF (16, T) is written on the walked columns
//     only; the wrapper zero-fills the rest.  A window that leaves the T
//     columns is a device-side assert (as PyTorch's own kernels treat an
//     index out of range): no host sync checks offs before the launch.
//   out (nblocks, 8, B*B): rows 0..2 rgb, 3 transmittance T, 4 done, 5 last
//     contributing candidate index + 1 (as float), 6..7 zero
//   g (nblocks, 8, B*B): cotangent of out (rows 0..3 used)
//   dF (nblocks, 16, K): rows 0..6 sum_p H(p) dpower, rows 8..10
//     sum_p g_rgb(p) w; rows 7, 11..15 zero
//
// What bounds them on this card.  The work depends on the data: a pixel
// evaluates candidates until it is done (forward) or back from its last
// contributor (backward).  Each (candidate, pixel) pair is >= 20 fp32
// operations forward; backward >= 16 (the gate) for every pair evaluated
// and >= 33 more for a contributing one.  The bytes (F once, out / g / dF
// once) are small, so both are bound by operations; chip_smoke.py counts
// the pairs of each run from the kernels' own outputs, the contributing
// ones by the forward's gates.
//
// Design.
//   K4: grid (nblocks, (B/16)^2): one 256-thread block per 16x16 sub-tile,
//       one pixel per thread, 256 candidates (10 rows) staged in shared
//       memory per step, front to back per pixel, block exit on
//       __syncthreads_and(done).  This is the TPU kernel's stop rule (a
//       pixel is done at the first candidate whose T_after falls below
//       t_min) evaluated sequentially instead of with a chunked cumprod.
//   K5: one 1024-thread block per pixel block, up to 4 pixels per thread,
//       walking candidates back to front from the block's largest last
//       contributor.  Per pixel it keeps T (recovered by division,
//       T_before = T_after / (1 - alpha)) and the suffix S of
//       w (c . g_rgb) seeded with T_final g_T, exactly the quantities of
//       _blend_bwd_kernel.  Per candidate the 9 distinct sums over the
//       block's pixels reduce by warp shuffles (skipped when the warp has
//       nothing) into one shared-memory partial per warp; every JS
//       candidates the partials are summed over the warps in a fixed order
//       and written, so dF is deterministic (the same windows give the same
//       bits in K5 and K9).  Each walked column of dF is written once, with
//       no atomics.
//   K8 / K9: the same two kernels on the packed addressing (window_of):
//       block b reads F columns offs[b] + j, walks n_live chunks of C like
//       the TPU kernels, and keeps its last-contributor index local to its
//       slice, as _blend_kernel_packed does.
// The power term is summed in the twin's order and this file is built with
// --fmad=false, so power and the gating decisions round as the twin's.

#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int FWD_THREADS = 256;   // 16 x 16 pixels
constexpr int BWD_THREADS = 1024;
constexpr int MAX_PPT = 4;         // pixels per backward thread (B <= 64)
constexpr int CH = 256;            // candidates staged per step
constexpr int JS = 32;             // candidates per backward partial sum
constexpr int NWARP = BWD_THREADS / 32;
constexpr int NROW = 10;           // staged F rows: 0..6 and 8..10
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int frow(int r) { return r < 7 ? r : r + 1; }

// Where block b's window lives.  Padded: F[b] (16, K), every column
// addressable; packed: the slice of the (16, T) array given by offs.
struct Window {
  size_t col0;  // offset of the window's column 0 in F (and dF)
  size_t ld;    // row stride of F
  int width;    // columns of the window
  int count;    // live candidates, <= width
};

template <bool PACKED>
__device__ __forceinline__ Window window_of(int b, const int* counts,
                                            const int* offs, int K, int C,
                                            int n_chunks) {
  Window w;
  w.ld = (size_t)K;  // K is T in the packed layout
  if (PACKED) {
    w.width = min((counts[b] + C - 1) / C, n_chunks) * C;
    // a block that walks nothing may carry any offset
    assert(w.width == 0 || (offs[b] >= 0 && offs[b] + w.width <= K));
    w.col0 = (size_t)offs[b];
  } else {
    w.col0 = (size_t)b * 16 * K;
    w.width = K;
  }
  w.count = counts ? min(counts[b], w.width) : w.width;
  return w;
}

__device__ __forceinline__ float power_of(float (*sF)[CH], int j,
                                          float pxx, float px, float pyy,
                                          float py, float pxy) {
  float power = sF[0][j] * pxx;
  power = power + sF[1][j] * px;
  power = power + sF[2][j];
  power = power + sF[3][j] * pyy;
  power = power + sF[4][j] * py;
  power = power + sF[5][j] * pxy;
  return power + sF[6][j];
}

template <bool PACKED>
__global__ void __launch_bounds__(FWD_THREADS)
blend_fwd_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                 const float* __restrict__ F, float* __restrict__ out, int K,
                 int C, int n_chunks, int B, float t_min, float alpha_min) {
  __shared__ float sF[NROW][CH];
  const int b = blockIdx.x;
  const int subs = B / 16;
  const int sx = blockIdx.y % subs, sy = blockIdx.y / subs;
  const int pxi = sx * 16 + (threadIdx.x & 15);
  const int pyi = sy * 16 + (threadIdx.x >> 4);
  const float px = (float)pxi, py = (float)pyi;
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const Window win = window_of<PACKED>(b, counts, offs, K, C, n_chunks);
  const float* Fb = F + win.col0;
  const int count = win.count;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, last = 0.0f;
  bool done = false;
  for (int base = 0; base < count; base += CH) {
    if (__syncthreads_and(done)) break;
    const int n = min(CH, count - base);
    for (int i = threadIdx.x; i < NROW * CH; i += FWD_THREADS) {
      const int r = i / CH, j = i % CH;
      sF[r][j] = j < n ? Fb[frow(r) * win.ld + base + j] : 0.0f;
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float power = power_of(sF, j, pxx, px, pyy, py, pxy);
        const float alpha = fminf(0.99f, expf(power));
        if (!(power <= sF[6][j] && alpha >= alpha_min)) continue;
        const float T_after = T * (1.0f - alpha);
        if (T_after < t_min) { done = true; break; }
        const float w = T * alpha;
        cr += sF[7][j] * w;
        cg += sF[8][j] * w;
        cb += sF[9][j] * w;
        T = T_after;
        last = (float)(base + j + 1);
      }
    }
    __syncthreads();  // the next step overwrites sF
  }
  const size_t P = (size_t)B * B;
  float* o = out + (size_t)b * 8 * P + (size_t)pyi * B + pxi;
  o[0 * P] = cr;
  o[1 * P] = cg;
  o[2 * P] = cb;
  o[3 * P] = T;
  o[4 * P] = done ? 1.0f : 0.0f;
  o[5 * P] = last;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

template <bool PACKED>
__global__ void __launch_bounds__(BWD_THREADS)
blend_bwd_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                 const float* __restrict__ F, const float* __restrict__ out,
                 const float* __restrict__ g, float* __restrict__ dF, int K,
                 int C, int n_chunks, int B, float alpha_min) {
  __shared__ float sF[NROW][CH];
  __shared__ float part[NWARP][9][JS];  // per-warp sums of JS candidates
  __shared__ int s_top;
  const int b = blockIdx.x;
  const int P = B * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Window win = window_of<PACKED>(b, counts, offs, K, C, n_chunks);
  const int W = win.width;
  const size_t ld = win.ld;
  const float* Fb = F + win.col0;
  float* dFb = dF + win.col0;
  const float* ob = out + (size_t)b * 8 * P;
  const float* gb = g + (size_t)b * 8 * P;

  float px[MAX_PPT], py[MAX_PPT], T[MAX_PPT], S[MAX_PPT];
  float gr[MAX_PPT], gg[MAX_PPT], gbl[MAX_PPT];
  int last[MAX_PPT];
  int my_top = 0;
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int p = threadIdx.x + k * BWD_THREADS;
    const bool ok = p < P;
    px[k] = (float)(p % B);
    py[k] = (float)(p / B);
    T[k] = ok ? ob[3 * P + p] : 1.0f;
    S[k] = ok ? T[k] * gb[3 * P + p] : 0.0f;
    gr[k] = ok ? gb[0 * P + p] : 0.0f;
    gg[k] = ok ? gb[1 * P + p] : 0.0f;
    gbl[k] = ok ? gb[2 * P + p] : 0.0f;
    last[k] = ok ? (int)ob[5 * P + p] : 0;
    my_top = max(my_top, last[k]);
  }
  if (threadIdx.x == 0) s_top = 0;
  __syncthreads();
  atomicMax(&s_top, my_top);
  __syncthreads();
  // candidates [0, top) hold every contributor of the block; the steps
  // past them only get zeros
  const int steps = (s_top + CH - 1) / CH;
  for (int i = min(W, steps * CH) + threadIdx.x; i < W; i += BWD_THREADS)
    for (int r = 0; r < 16; ++r) dFb[r * ld + i] = 0.0f;

  for (int step = steps - 1; step >= 0; --step) {
    const int base = step * CH;
    const int n = min(CH, W - base);
    for (int i = threadIdx.x; i < NROW * CH; i += BWD_THREADS) {
      const int r = i / CH, j = i % CH;
      sF[r][j] = j < n ? Fb[frow(r) * ld + base + j] : 0.0f;
    }
    __syncthreads();
    for (int j0 = (n - 1) / JS * JS; j0 >= 0; j0 -= JS) {
      const int jn = min(JS, n - j0);
      for (int jj = jn - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        const int idx1 = base + j + 1;
        float v[9];
#pragma unroll
        for (int r = 0; r < 9; ++r) v[r] = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < MAX_PPT; ++k) {
          if (idx1 > last[k]) continue;
          const float pxx = px[k] * px[k], pyy = py[k] * py[k];
          const float pxy = px[k] * py[k];
          const float power = power_of(sF, j, pxx, px[k], pyy, py[k], pxy);
          const float expp = expf(power);
          const float alpha = fminf(0.99f, expp);
          if (!(power <= sF[6][j] && alpha >= alpha_min)) continue;
          const float one_minus = 1.0f - alpha;
          const float T_before = T[k] / one_minus;
          const float w = T_before * alpha;
          const float cdot = sF[7][j] * gr[k] + sF[8][j] * gg[k]
                             + sF[9][j] * gbl[k];
          const float dA = T_before * cdot - S[k] / one_minus;
          const float dP = expp < 0.99f ? dA * alpha : 0.0f;
          S[k] += w * cdot;
          T[k] = T_before;
          v[0] += pxx * dP;
          v[1] += px[k] * dP;
          v[2] += dP;
          v[3] += pyy * dP;
          v[4] += py[k] * dP;
          v[5] += pxy * dP;
          v[6] += gr[k] * w;
          v[7] += gg[k] * w;
          v[8] += gbl[k] * w;
          any = true;
        }
        const bool warp_any = __any_sync(FULL, any);
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          float x = v[r];
          if (warp_any) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              x += __shfl_xor_sync(FULL, x, off);
          }
          if (lane == 0) part[warp][r][jj] = x;
        }
      }
      __syncthreads();
      // the warps' partials summed in warp order: dF rows 0..5 the monomial
      // sums, 6 the log opacity (= row 2's sum of dP), 8..10 the colors
      for (int i = threadIdx.x; i < 16 * JS; i += BWD_THREADS) {
        const int r = i / JS, jj = i % JS;
        if (jj >= jn) continue;
        int src = -1;
        if (r <= 5) src = r;
        else if (r == 6) src = 2;
        else if (r >= 8 && r <= 10) src = r - 2;
        float x = 0.0f;
        if (src >= 0)
          for (int w = 0; w < NWARP; ++w) x += part[w][src][jj];
        dFb[r * ld + base + j0 + jj] = x;
      }
      __syncthreads();  // the next JS candidates overwrite part
    }
  }
}

}  // namespace

extern "C" {

const char* gsmpm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gsmpm_blend_fwd(const int* counts, const float* F, float* out, int nb,
                    int K, int B, float t_min, float alpha_min, void* stream) {
  if (nb <= 0) return cudaSuccess;
  const dim3 grid(nb, (B / 16) * (B / 16));
  blend_fwd_kernel<false>
      <<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          counts, nullptr, F, out, K, 1, 0, B, t_min, alpha_min);
  return cudaGetLastError();
}

int gsmpm_blend_bwd(const float* F, const float* out, const float* g,
                    float* dF, int nb, int K, int B, float alpha_min,
                    void* stream) {
  if (nb <= 0) return cudaSuccess;
  blend_bwd_kernel<false>
      <<<nb, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          nullptr, nullptr, F, out, g, dF, K, 1, 0, B, alpha_min);
  return cudaGetLastError();
}

int gsmpm_blend_packed_fwd(const int* counts, const int* offs, const float* F,
                           float* out, int nb, int T, int C, int n_chunks,
                           int B, float t_min, float alpha_min,
                           void* stream) {
  if (nb <= 0) return cudaSuccess;
  const dim3 grid(nb, (B / 16) * (B / 16));
  blend_fwd_kernel<true>
      <<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          counts, offs, F, out, T, C, n_chunks, B, t_min, alpha_min);
  return cudaGetLastError();
}

int gsmpm_blend_packed_bwd(const int* counts, const int* offs, const float* F,
                           const float* out, const float* g, float* dF,
                           int nb, int T, int C, int n_chunks, int B,
                           float alpha_min, void* stream) {
  if (nb <= 0) return cudaSuccess;
  blend_bwd_kernel<true>
      <<<nb, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          counts, offs, F, out, g, dF, T, C, n_chunks, B, alpha_min);
  return cudaGetLastError();
}

}  // extern "C"
