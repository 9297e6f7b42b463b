// Sorted-segment stream blend, forward and backward, for Hopper (sm_90a),
// fp32.
//
// Replaces the Pallas TPU kernels of gsmpm_tpu/render/stream_raster.py:
//   K3 _stream_fwd_kernel (launcher _stream_core)      -> gsmpm_stream_fwd
//   K7 _stream_bwd_kernel (launcher _stream_core_bwd)  -> gsmpm_stream_bwd
// Plain twins: gsmpm_tpu_torch/render/stream_raster.py stream_blend_ref /
// stream_blend_bwd_ref.
//
// Inputs: splanes (9, L) depth-sorted stream (rows gx, gy, conic a, b, c,
// log opacity, r, g, b); bounds (nf+1,) int32, display block b owning slots
// [bounds[b], bounds[b+1]).  Blend state out (nf, 8, B*B): rows 0..2 rgb, 3
// transmittance T, 4 done, 5 last contributing global slot + 1 (as float,
// exact below 2^24 slots; the wrapper checks), 6..7 zero.  K3 writes every
// block, blocks with an empty segment too (rgb 0, T 1).  K7 takes out and
// its cotangent g (rows 0..3 used) and writes d(splanes) (9, L) for the
// slots it walks; the wrapper zero-fills the rest.
//
// What bounds them on this card.  Work depends on the data: in K3 each
// pixel evaluates the slots of its block's segment up to its last
// contributor once it is done, else to the segment's end; in K7 each pixel
// evaluates the slots from its last contributor back to the segment start.
// Each (slot, pixel) pair takes at least 20 fp32 operations forward (6 mul
// + 6 add for the power term, exp, clamp, two compares, the transmittance
// and three color updates).  Backward, every pair evaluated takes the gate
// (16) and a pair that contributes at least 33 more (the division, w,
// c . g, dA, dpower, the suffix and 9 accumulating multiply-adds).  The
// bytes are small: the
// stream (36 B per slot, 30 MB at the simulate path's 0.84 M slots), the
// blend state and, for K7, the cotangent and d(splanes).  So both are
// bound by operations; chip_smoke.py counts the pairs, and the
// contributing ones by the forward's gates, on each run's data.
//
// Design.
//   K3: the TPU kernel walks a chunk-major grid from scalar-prefetched step
//       tables and evaluates a chunk of slots against all 4096 block pixels
//       as an MXU matmul with a log-depth cumulative product.  Here grid
//       (nf, (B/16)^2) gives each 16x16-pixel sub-tile of a display block
//       one 256-thread block, one pixel per thread; the block reads bounds
//       itself, stages the segment in shared memory 256 slots (9 planes) at
//       a time, and every thread composites its pixel sequentially front to
//       back, which is exactly the stop rule of the TPU kernel (a pixel is
//       done at the first slot whose T_after would fall below t_min;
//       T_after decreases monotonically, so the chunked and the sequential
//       forms agree up to rounding of the transmittance product).  The
//       block leaves its segment as soon as __syncthreads_and(done) holds.
//   K7: one 1024-thread block per display block, up to 4 pixels per thread
//       (K5's design in csrc/tile_blend.cu, over a segment of raw planes).
//       The block finds its largest last contributor by one shared atomic
//       max and walks its segment back to front from there, 256 slots
//       staged per step with their F coefficients built once per slot.  Per
//       pixel it keeps T (recovered by division, T_before = T_after /
//       (1 - alpha)) and the suffix S of w (c . g_rgb) seeded with T_final
//       g_T, the quantities of _stream_bwd_kernel.  Per slot 9 sums over
//       the block's pixels reduce by warp shuffles (skipped when the warp
//       has nothing) and one shared atomic per warp: dpower times the
//       monomials dx^2, dx dy, dy^2, dx, dy, 1 of the pixel's offset (dx,
//       dy) from the splat's centre, and g_rgb w for the colors.  Then one
//       thread per slot applies the chain rule to the 9 raw rows and writes
//       the slot's column once.  This is the transpose of the F build
//       (gsmpm_tpu's in-kernel chain rule) in centred coordinates: the TPU
//       kernel's sums over the block-local monomials px^2, px, 1, ...
//       cancel for a splat of a pixel or two (d a = -0.5 sum (px - gx)^2
//       dpower formed as a difference of terms ~gx^2 larger), which turns
//       fp32 rounding into 1e-4 relative errors at the fit's shapes.  Every slot belongs to
//       exactly one segment, so no block adds into another's output: the
//       TPU kernel's straddled-window accumulation has no counterpart.
// The F coefficients and the power term are computed with the same
// expressions in the same order in both kernels and the twins, and this
// file is built with --fmad=false, so K7 reaches K3's gate decisions
// (power <= log opacity, alpha >= alpha_min, slot <= last) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // K3: 16 x 16 pixels
constexpr int CH = 256;            // slots staged per step
constexpr int BWD_THREADS = 1024;  // K7
constexpr int MAX_PPT = 4;         // pixels per K7 thread (B <= 64)
constexpr unsigned FULL = 0xffffffffu;

// The quadratic form's coefficients of the block-local pixel monomials
// [px^2, px, 1, py^2, py, px py] of a splat at block offset (gx, gy) with
// conic (a, b, c): gsmpm_tpu's _build_F_chunk rows 0..5.
__device__ __forceinline__ void conic_rows(float gx, float gy, float a,
                                           float bb, float c, float* F) {
  F[0] = -0.5f * a;
  F[1] = a * gx + bb * gy;
  F[2] = -0.5f * (a * gx * gx + c * gy * gy) - bb * gx * gy;
  F[3] = -0.5f * c;
  F[4] = c * gy + bb * gx;
  F[5] = -bb;
}

// log alpha of one (slot, pixel) pair, summed in the twins' order
__device__ __forceinline__ float power_of(float F0, float F1, float F2,
                                          float F3, float F4, float F5,
                                          float logo, float pxx, float px,
                                          float pyy, float py, float pxy) {
  float power = F0 * pxx;
  power = power + F1 * px;
  power = power + F2;
  power = power + F3 * pyy;
  power = power + F4 * py;
  power = power + F5 * pxy;
  return power + logo;
}

__global__ void __launch_bounds__(THREADS)
stream_fwd_kernel(const float* __restrict__ splanes, int L,
                  const int* __restrict__ bounds, float* __restrict__ out,
                  int nbx, int B, float t_min, float alpha_min) {
  __shared__ float sp[9][CH];
  const int b = blockIdx.x;
  const int subs = B / 16;
  const int sx = blockIdx.y % subs, sy = blockIdx.y / subs;
  const int lx = threadIdx.x & 15, ly = threadIdx.x >> 4;
  const int pxi = sx * 16 + lx, pyi = sy * 16 + ly;
  const int pix = pyi * B + pxi;
  const float px = (float)pxi, py = (float)pyi;
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const float x0 = (float)((b % nbx) * B), y0 = (float)((b / nbx) * B);
  const int lo = bounds[b], hi = bounds[b + 1];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, last = 0.0f;
  bool done = false;
  for (int base = lo; base < hi; base += CH) {
    if (__syncthreads_and(done)) break;
    const int n = min(CH, hi - base);
    for (int i = threadIdx.x; i < 9 * CH; i += THREADS) {
      const int row = i / CH, j = i % CH;
      sp[row][j] = j < n ? splanes[(size_t)row * L + base + j] : 0.0f;
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        float F[6];
        conic_rows(sp[0][j] - x0, sp[1][j] - y0, sp[2][j], sp[3][j],
                   sp[4][j], F);
        const float logo = sp[5][j];
        const float power = power_of(F[0], F[1], F[2], F[3], F[4], F[5],
                                     logo, pxx, px, pyy, py, pxy);
        float alpha = fminf(0.99f, expf(power));
        if (!(power <= logo && alpha >= alpha_min)) continue;  // alpha = 0
        const float T_after = T * (1.0f - alpha);
        if (T_after < t_min) { done = true; break; }
        const float w = T * alpha;
        cr += sp[6][j] * w;
        cg += sp[7][j] * w;
        cb += sp[8][j] * w;
        T = T_after;
        last = (float)(base + j + 1);
      }
    }
    __syncthreads();  // the next step overwrites sp
  }
  const size_t P = (size_t)B * B;
  float* o = out + (size_t)b * 8 * P + pix;
  o[0 * P] = cr;
  o[1 * P] = cg;
  o[2 * P] = cb;
  o[3 * P] = T;
  o[4 * P] = done ? 1.0f : 0.0f;
  o[5 * P] = last;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

__global__ void __launch_bounds__(BWD_THREADS)
stream_bwd_kernel(const float* __restrict__ splanes, int L,
                  const int* __restrict__ bounds,
                  const float* __restrict__ out, const float* __restrict__ g,
                  float* __restrict__ dsp, int nbx, int B, float alpha_min) {
  __shared__ float sp[9][CH];   // raw planes of the staged slots
  __shared__ float sF[6][CH];   // their conic rows
  __shared__ float acc[9][CH];  // per-slot sums over the block's pixels
  __shared__ int s_top;
  const int b = blockIdx.x;
  const int P = B * B;
  const int lane = threadIdx.x & 31;
  const float x0 = (float)((b % nbx) * B), y0 = (float)((b / nbx) * B);
  const int lo = bounds[b], hi = bounds[b + 1];
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
  // slots [lo, top) hold every contributor of the block
  const int top = min(s_top, hi);
  const int steps = top > lo ? (top - lo + CH - 1) / CH : 0;

  for (int step = steps - 1; step >= 0; --step) {
    const int base = lo + step * CH;
    const int n = min(CH, hi - base);
    for (int i = threadIdx.x; i < 9 * CH; i += BWD_THREADS) {
      const int r = i / CH, j = i % CH;
      sp[r][j] = j < n ? splanes[(size_t)r * L + base + j] : 0.0f;
      (&acc[0][0])[i] = 0.0f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += BWD_THREADS) {
      float F[6];
      conic_rows(sp[0][j] - x0, sp[1][j] - y0, sp[2][j], sp[3][j], sp[4][j],
                 F);
#pragma unroll
      for (int r = 0; r < 6; ++r) sF[r][j] = F[r];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      const int idx1 = base + j + 1;
      const float gxs = sp[0][j] - x0, gys = sp[1][j] - y0;
      float v[9];
#pragma unroll
      for (int r = 0; r < 9; ++r) v[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < MAX_PPT; ++k) {
        if (idx1 > last[k]) continue;
        const float pxx = px[k] * px[k], pyy = py[k] * py[k];
        const float pxy = px[k] * py[k];
        const float logo = sp[5][j];
        const float power = power_of(sF[0][j], sF[1][j], sF[2][j], sF[3][j],
                                     sF[4][j], sF[5][j], logo, pxx, px[k],
                                     pyy, py[k], pxy);
        const float expp = expf(power);
        const float alpha = fminf(0.99f, expp);
        if (!(power <= logo && alpha >= alpha_min)) continue;
        const float one_minus = 1.0f - alpha;
        const float T_before = T[k] / one_minus;
        const float w = T_before * alpha;
        const float cdot = sp[6][j] * gr[k] + sp[7][j] * gg[k]
                           + sp[8][j] * gbl[k];
        const float dA = T_before * cdot - S[k] / one_minus;
        const float dP = expp < 0.99f ? dA * alpha : 0.0f;
        S[k] += w * cdot;
        T[k] = T_before;
        // the power's monomials centred on the splat: no cancellation
        const float dx = px[k] - gxs, dy = py[k] - gys;
        v[0] += dx * dx * dP;
        v[1] += dx * dy * dP;
        v[2] += dy * dy * dP;
        v[3] += dx * dP;
        v[4] += dy * dP;
        v[5] += dP;
        v[6] += gr[k] * w;
        v[7] += gg[k] * w;
        v[8] += gbl[k] * w;
        any = true;
      }
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          float x = v[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(FULL, x, off);
          if (lane == 0 && x != 0.0f) atomicAdd(&acc[r][j], x);
        }
      }
    }
    __syncthreads();
    // the F build's transpose to the 9 raw rows, one thread per slot:
    // power = -0.5 a dx^2 - b dx dy - 0.5 c dy^2 + log opacity
    for (int j = threadIdx.x; j < n; j += BWD_THREADS) {
      const float a = sp[2][j], bb = sp[3][j], c = sp[4][j];
      const float sx = acc[3][j], sy = acc[4][j];
      float* o = dsp + base + j;
      o[0 * (size_t)L] = a * sx + bb * sy;
      o[1 * (size_t)L] = bb * sx + c * sy;
      o[2 * (size_t)L] = -0.5f * acc[0][j];
      o[3 * (size_t)L] = -acc[1][j];
      o[4 * (size_t)L] = -0.5f * acc[2][j];
      o[5 * (size_t)L] = acc[5][j];
      o[6 * (size_t)L] = acc[6][j];
      o[7 * (size_t)L] = acc[7][j];
      o[8 * (size_t)L] = acc[8][j];
    }
    __syncthreads();  // the next step overwrites sp, sF and acc
  }
}

}  // namespace

extern "C" {

const char* gsmpm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gsmpm_stream_fwd(const float* splanes, int L, const int* bounds,
                     float* out, int nf, int nbx, int B, float t_min,
                     float alpha_min, void* stream) {
  if (nf <= 0) return cudaSuccess;
  const dim3 grid(nf, (B / 16) * (B / 16));
  stream_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      splanes, L, bounds, out, nbx, B, t_min, alpha_min);
  return cudaGetLastError();
}

int gsmpm_stream_bwd(const float* splanes, int L, const int* bounds,
                     const float* out, const float* g, float* dsp, int nf,
                     int nbx, int B, float alpha_min, void* stream) {
  if (nf <= 0) return cudaSuccess;
  stream_bwd_kernel<<<nf, BWD_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      splanes, L, bounds, out, g, dsp, nbx, B, alpha_min);
  return cudaGetLastError();
}

}  // extern "C"
