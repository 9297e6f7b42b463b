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
// K3's pixels skip the slots whose splat's box misses their warp's 16 x 8
// group, then the pixel (below): a few compares instead of the gate, so the
// bound counts the pairs of the walk whose pixel lies in the slot's box;
// K7 skips them the same way, backward.
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
//       as an MXU matmul with a log-depth cumulative product.  Here one
//       1024-thread block takes a whole 64 x 64 display block (larger
//       blocks take several CUDA blocks), one 16 x 8 pixel group per warp,
//       4 pixels per lane.  The block reads bounds itself and walks its
//       segment 256 slots at a time.  Each staged slot is read once per
//       display block (the first design staged it once per 16 x 16
//       sub-tile, 16 times): one thread builds its conic rows (K7's
//       expressions) and the box outside which its splat cannot pass the
//       gate (power = log opacity - q/2 needs q <= 2 (log opacity -
//       ln alpha_min): the ellipse's half-extents sqrt(2k c / det),
//       sqrt(2k a / det), widened by one pixel and 0.1% against the
//       rounding of the F form; a slot with k < 0 is culled everywhere, a
//       conic that is not positive definite nowhere).  Each warp then
//       compacts, by ballot, the staged slots whose box meets its
//       rectangle into a list in slot order, and its lanes composite their
//       pixels sequentially front to back over that list, skipping a slot
//       for a pixel outside its box (two compares before the 7-term power
//       and the exp).  A culled (slot, pixel) pair is one the gate would
//       have rejected, so each
//       pixel still meets its contributors in the same order with the same
//       expressions: the rgb, T, done and last bits of the unculled walk.
//       This is the stop rule of the TPU kernel (a pixel is done at the
//       first slot whose T_after would fall below t_min; T_after decreases
//       monotonically, so the chunked and the sequential forms agree up to
//       rounding of the transmittance product).  The block leaves its
//       segment as soon as every pixel of it is done.
//   K7: the reverse walk of csrc/reverse_walk.cuh over a segment of raw
//       planes.  Each display block is a cluster of ceil(groups / 8) CUDA
//       blocks of 8 warps, one warp per 16 x 8 pixel group (4 blocks at B =
//       64: 256 CUDA blocks at the stream fit's 64 display blocks, where one
//       1024-thread block per display block kept 64 of the 132 SMs busy).
//       The cluster walks its segment back to front from its largest last
//       contributor, 256 slots staged per step with K3's expressions: the
//       conic rows and slot_box, K3's box.  A warp walks only the staged
//       slots before its own last contributor whose box meets its group,
//       and a lane only the pixels inside the box.  Per pixel it keeps T
//       (recovered by division, T_before = T_after / (1 - alpha)) and the
//       suffix S of w (c . g_rgb) seeded with T_final g_T, the quantities
//       of _stream_bwd_kernel.  Per slot 9 sums over the block's pixels:
//       dpower times the monomials dx^2, dx dy, dy^2, dx, dy, 1 of the
//       pixel's offset (dx, dy) from the splat's centre, and g_rgb w for
//       the colors, stored only by warps that reached the slot and summed
//       in a fixed order (the lanes by butterfly, the warps in order, the
//       cluster's blocks in rank order through distributed shared memory),
//       so d(splanes) has the same bits in every run (the shared atomics
//       of the first design did not).  Then one thread per slot applies
//       the chain rule to the 9 raw rows and writes the slot's column once
//       (a slot no pixel reached keeps the wrapper's zeros).  This is the
//       transpose of the F build (gsmpm_tpu's in-kernel chain rule) in
//       centred coordinates: the TPU kernel's sums over the block-local
//       monomials px^2, px, 1, ... cancel for a splat of a pixel or two (d
//       a = -0.5 sum (px - gx)^2 dpower formed as a difference of terms
//       ~gx^2 larger), which turns fp32 rounding into 1e-4 relative errors
//       at the fit's shapes.  Every slot belongs to exactly one segment, so
//       no cluster writes into another's output: the TPU kernel's
//       straddled-window accumulation has no counterpart.
// The F coefficients and the power term are computed with the same
// expressions in the same order in both kernels and the twins, and this
// file is built with --fmad=false, so K7 reaches K3's gate decisions
// (power <= log opacity, alpha >= alpha_min, slot <= last) bit for bit.

#include <cuda_runtime.h>

#include "reverse_walk.cuh"

namespace {

constexpr int FWD_WARPS = 32;      // K3: one 16 x 8 pixel group per warp
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_PPT = 4;         // pixels per K3 lane
// slots staged per step, as in the reverse walk (the lists hold slot
// indices in a byte)
using rwalk::CH;
using rwalk::FULL;

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

using rwalk::power_of;  // log alpha of a (slot, pixel) pair

// The box, in block-local pixels, outside which a splat at block offset
// (gx, gy) with conic (a, b, c) and log opacity logo cannot pass the gate
// (stream_raster.cull_boxes in plain torch).  power = log opacity - q / 2,
// q = a dx^2 + 2 b dx dy + c dy^2, so the gate needs q <= 2 k with k = log
// opacity - ln(alpha_min) (log_amin carries 1e-3 of slack for expf): none
// when k < 0, else |dx| <= sqrt(2 k c / det), |dy| <= sqrt(2 k a / det),
// widened by 0.1% and one pixel against the rounding of the F form.  A
// conic that is not positive definite is never culled by its box.
__device__ __forceinline__ void slot_box(float gx, float gy, float a,
                                         float bb, float c, float logo,
                                         float log_amin, float* box) {
  const float k = logo - log_amin;
  const float det = a * c - bb * bb;
  const float inf = __int_as_float(0x7f800000);
  float xl = -inf, xh = inf, yl = -inf, yh = inf;
  if (!(k >= 0.0f)) {
    xl = inf;  // culled everywhere (NaN planes too)
  } else if (a > 0.0f && c > 0.0f && det > 0.0f) {
    const float ex = sqrtf(2.0f * k * c / det) * 1.001f + 1.0f;
    const float ey = sqrtf(2.0f * k * a / det) * 1.001f + 1.0f;
    xl = gx - ex; xh = gx + ex; yl = gy - ey; yh = gy + ey;
  }
  box[0] = xl; box[1] = xh; box[2] = yl; box[3] = yh;
}

__global__ void __launch_bounds__(FWD_THREADS)
stream_fwd_kernel(const float* __restrict__ splanes, int L,
                  const int* __restrict__ bounds, float* __restrict__ out,
                  int nbx, int B, float t_min, float alpha_min) {
  __shared__ float sF[10][CH];             // conic rows, log opacity, rgb
  __shared__ float box[4][CH];             // x lo, x hi, y lo, y hi
  __shared__ unsigned char list[FWD_WARPS][CH];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  // this warp's 16 x 8 pixel group; a lane owns column lx of rows ly,
  // ly + 2, ly + 4, ly + 6
  const int rect = blockIdx.y * FWD_WARPS + wid;
  const int rects_x = B / 16;
  const bool has_rect = rect < rects_x * (B / 8);
  const int rx0 = (rect % rects_x) * 16, ry0 = (rect / rects_x) * 8;
  const float rxlo = (float)rx0, rylo = (float)ry0;
  const float px = (float)(rx0 + (lane & 15));
  const float pxx = px * px;
  float py[FWD_PPT], T[FWD_PPT], cr[FWD_PPT], cg[FWD_PPT], cb[FWD_PPT];
  float last[FWD_PPT];
  bool done[FWD_PPT];
#pragma unroll
  for (int k = 0; k < FWD_PPT; ++k) {
    py[k] = (float)(ry0 + (lane >> 4) + 2 * k);
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = last[k] = 0.0f;
    done[k] = !has_rect;
  }
  const float x0 = (float)((b % nbx) * B), y0 = (float)((b / nbx) * B);
  const int lo = bounds[b], hi = bounds[b + 1];
  // the gate needs exp(power) >= alpha_min with power <= log opacity; the
  // 1e-3 slack in log space covers expf's rounding
  const float log_amin = logf(alpha_min) - 1e-3f;

  for (int base = lo; base < hi; base += CH) {
    bool mine = true;
#pragma unroll
    for (int k = 0; k < FWD_PPT; ++k) mine = mine && done[k];
    if (__syncthreads_and(mine)) break;
    const int n = min(CH, hi - base);
    // stage each slot once: its conic rows (K7's expressions) and the box
    // outside which its splat cannot pass the gate
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const size_t i = (size_t)base + j;
      const float gx = splanes[i] - x0, gy = splanes[L + i] - y0;
      const float a = splanes[2 * (size_t)L + i];
      const float bb = splanes[3 * (size_t)L + i];
      const float c = splanes[4 * (size_t)L + i];
      const float logo = splanes[5 * (size_t)L + i];
      float F[6];
      conic_rows(gx, gy, a, bb, c, F);
#pragma unroll
      for (int r = 0; r < 6; ++r) sF[r][j] = F[r];
      sF[6][j] = logo;
#pragma unroll
      for (int r = 0; r < 3; ++r) sF[7 + r][j] = splanes[(6 + r) * (size_t)L + i];
      float bx[4];
      slot_box(gx, gy, a, bb, c, logo, log_amin, bx);
#pragma unroll
      for (int r = 0; r < 4; ++r) box[r][j] = bx[r];
    }
    __syncthreads();
    // this warp's list: the staged slots whose box meets its rectangle, in
    // slot order
    const int count =
        __all_sync(FULL, mine)
            ? 0
            : rwalk::warp_list(box[0], box[1], box[2], box[3], n, rxlo, rylo,
                               list[wid], lane);
    for (int e = 0; e < count; ++e) {
      const int j = list[wid][e];
      // the same box, per pixel: a lane's 4 pixels share its column
      if (px < box[0][j] || px > box[1][j]) continue;
      const float yl = box[2][j], yh = box[3][j];
      const float F0 = sF[0][j], F1 = sF[1][j], F2 = sF[2][j];
      const float F3 = sF[3][j], F4 = sF[4][j], F5 = sF[5][j];
      const float logo = sF[6][j];
#pragma unroll
      for (int k = 0; k < FWD_PPT; ++k) {
        if (done[k] || py[k] < yl || py[k] > yh) continue;
        const float power = power_of(F0, F1, F2, F3, F4, F5, logo, pxx, px,
                                     py[k] * py[k], py[k], px * py[k]);
        const float alpha = fminf(0.99f, expf(power));
        if (!(power <= logo && alpha >= alpha_min)) continue;  // alpha = 0
        const float T_after = T[k] * (1.0f - alpha);
        if (T_after < t_min) { done[k] = true; continue; }
        const float w = T[k] * alpha;
        cr[k] += sF[7][j] * w;
        cg[k] += sF[8][j] * w;
        cb[k] += sF[9][j] * w;
        T[k] = T_after;
        last[k] = (float)(base + j + 1);
      }
    }
    __syncthreads();  // the next step overwrites sF, box and the lists
  }
  if (!has_rect) return;
  const size_t P = (size_t)B * B;
#pragma unroll
  for (int k = 0; k < FWD_PPT; ++k) {
    const int pix = (ry0 + (lane >> 4) + 2 * k) * B + rx0 + (lane & 15);
    float* o = out + (size_t)b * 8 * P + pix;
    o[0 * P] = cr[k];
    o[1 * P] = cg[k];
    o[2 * P] = cb[k];
    o[3 * P] = T[k];
    o[4 * P] = done[k] ? 1.0f : 0.0f;
    o[5 * P] = last[k];
    o[6 * P] = 0.0f;
    o[7 * P] = 0.0f;
  }
}

// staged rows of a slot: conic rows F0..F5 (0..5), log opacity (6), rgb
// (7..9), the splat's block offset gx, gy (10, 11), its conic a, b, c
// (12..14) and its box (15..18)
constexpr int BWD_NS = 19;

__global__ void __launch_bounds__(rwalk::NW * 32, 2)
stream_bwd_kernel(const float* __restrict__ splanes, int L,
                  const int* __restrict__ bounds,
                  const float* __restrict__ out, const float* __restrict__ g,
                  float* __restrict__ dsp, int nbx, int B, float alpha_min) {
  using Sh = rwalk::Shared<BWD_NS>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  cooperative_groups::cluster_group cl =
      cooperative_groups::this_cluster();
  const int nranks = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / nranks;
  const int P = B * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float x0 = (float)((b % nbx) * B), y0 = (float)((b / nbx) * B);
  const int lo = bounds[b], hi = bounds[b + 1];

  rwalk::Lane ln;
  rwalk::load_lane(ln, rank * rwalk::NW + warp, B,
                   out + (size_t)b * 8 * P, g + (size_t)b * 8 * P, lane);
  // slots [lo, top) hold every contributor of the block
  const int top = min(rwalk::cluster_top(cl, sh, ln, lane), hi);
  const int steps = top > lo ? (top - lo + CH - 1) / CH : 0;
  const float log_amin = logf(alpha_min) - 1e-3f;

  for (int step = steps - 1; step >= 0; --step) {
    const int base = lo + step * CH;
    const int n = min(CH, hi - base);
    const int q = step & 1;  // this step's buffer of the block's sums
    // stage each slot once: its conic rows (K3's expressions) and box
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const size_t i = (size_t)base + j;
      const float gx = splanes[i] - x0, gy = splanes[L + i] - y0;
      const float a = splanes[2 * (size_t)L + i];
      const float bb = splanes[3 * (size_t)L + i];
      const float c = splanes[4 * (size_t)L + i];
      const float logo = splanes[5 * (size_t)L + i];
      float F[6], box[4];
      conic_rows(gx, gy, a, bb, c, F);
      slot_box(gx, gy, a, bb, c, logo, log_amin, box);
#pragma unroll
      for (int r = 0; r < 6; ++r) sh.st[r][j] = F[r];
      sh.st[6][j] = logo;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        sh.st[7 + r][j] = splanes[(6 + r) * (size_t)L + i];
      sh.st[10][j] = gx;
      sh.st[11][j] = gy;
      sh.st[12][j] = a;
      sh.st[13][j] = bb;
      sh.st[14][j] = c;
#pragma unroll
      for (int r = 0; r < 4; ++r) sh.st[15 + r][j] = box[r];
    }
    rwalk::clear_mask(sh, warp, lane);
    __syncthreads();
    const int count = rwalk::warp_list(sh.st[15], sh.st[16], sh.st[17],
                                       sh.st[18], min(n, ln.top - base),
                                       ln.rx0, ln.ry0, sh.list[warp], lane);
    for (int e = count - 1; e >= 0; --e) {
      const int j = sh.list[warp][e];
      float v[rwalk::NSUM];
#pragma unroll
      for (int r = 0; r < rwalk::NSUM; ++r) v[r] = 0.0f;
      bool any = false;
      if (ln.px >= sh.st[15][j] && ln.px <= sh.st[16][j]) {
        rwalk::Slot sl;
#pragma unroll
        for (int r = 0; r < 7; ++r) sl.F[r] = sh.st[r][j];
#pragma unroll
        for (int r = 0; r < 3; ++r) sl.c[r] = sh.st[7 + r][j];
        sl.gx = sh.st[10][j];
        sl.gy = sh.st[11][j];
        sl.yl = sh.st[17][j];
        sl.yh = sh.st[18][j];
        any = rwalk::walk_slot<true>(ln, base + j + 1, sl, alpha_min,
                                          v);
      }
      rwalk::warp_emit(sh, warp, lane, j, v, any);
    }
    __syncthreads();
    rwalk::block_sum(sh, n, q);
    cl.sync();
    // this block's slice of the step's slots, totalled over the cluster,
    // through the F build's transpose to the 9 raw rows: power = -0.5 a
    // dx^2 - b dx dy - 0.5 c dy^2 + log opacity.  A slot no pixel reached
    // keeps the wrapper's zeros.
    int j0, j1;
    rwalk::slice_of(cl, n, j0, j1);
    for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
      float t[rwalk::NSUM];
      if (!rwalk::cluster_total(cl, sh, j, q, t)) continue;
      const float a = sh.st[12][j], bb = sh.st[13][j], c = sh.st[14][j];
      float* o = dsp + base + j;
      o[0 * (size_t)L] = a * t[3] + bb * t[4];
      o[1 * (size_t)L] = bb * t[3] + c * t[4];
      o[2 * (size_t)L] = -0.5f * t[0];
      o[3 * (size_t)L] = -t[1];
      o[4 * (size_t)L] = -0.5f * t[2];
      o[5 * (size_t)L] = t[5];
      o[6 * (size_t)L] = t[6];
      o[7 * (size_t)L] = t[7];
      o[8 * (size_t)L] = t[8];
    }
    __syncthreads();  // the next step overwrites the staged rows
  }
  cl.sync();  // every block has read this block's sums
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
  // one warp per 16 x 8 pixel group; a display block's groups share one
  // CUDA block up to B = 64, larger blocks take several
  const int rects = (B / 16) * (B / 8);
  const dim3 grid(nf, (rects + FWD_WARPS - 1) / FWD_WARPS);
  const int threads = 32 * min(rects, FWD_WARPS);
  stream_fwd_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      splanes, L, bounds, out, nbx, B, t_min, alpha_min);
  return cudaGetLastError();
}

// CUDA blocks of a K7 launch over nf display blocks of edge B
int gsmpm_stream_bwd_blocks(int nf, int B) { return rwalk::grid_of(nf, B); }

int gsmpm_stream_bwd(const float* splanes, int L, const int* bounds,
                     const float* out, const float* g, float* dsp, int nf,
                     int nbx, int B, float alpha_min, void* stream) {
  if (nf <= 0) return cudaSuccess;
  return rwalk::launch<rwalk::Shared<BWD_NS>>(
      stream_bwd_kernel, nf, B, static_cast<cudaStream_t>(stream), splanes,
      L, bounds, out, g, dsp, nbx, B, alpha_min);
}

}  // extern "C"
