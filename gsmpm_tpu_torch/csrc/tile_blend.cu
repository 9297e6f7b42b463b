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
// and >= 33 more for a contributing one.  All four skip the pairs outside
// the candidate's box (below) with a few compares, so their bounds charge
// the gate to the walked pairs inside it; K4 / K8 must read the F rows of
// the candidates before each window's depth (where its last pixel stops).
// So counted, the bytes (F once, out / g / dF once) set the bounds;
// chip_smoke.py counts the pairs of each run from the kernels' own
// outputs, the contributing ones by the forward's gates.  What holds the
// walks back is one window's depth: a window is walked in order, so the
// deepest (the fit's central one: 23,199 candidates, 91 steps of 256)
// sets the launch's time while most blocks have finished.
//
// Design.
//   K4: the forward walk of K3 (csrc/stream_raster.cu) on a candidate
//       window.  A warp per 16 x 8 pixel group (a lane: one column, 4 rows),
//       8 warps a CUDA block, ceil(groups / 8) independent CUDA blocks per
//       pixel block (160 on the fit's 40 tier-2 windows).  Each CUDA block
//       stages 256 candidates a step, one per thread: its 10 used F rows
//       (loaded during the previous step's walk) and the box window_box
//       derives from them.  A warp lists by ballot the staged candidates
//       whose box meets its group and walks them front to back; a lane
//       skips a candidate whose box misses its pixel before the power and
//       the exp, and a block leaves the window when all its pixels are
//       done.  A culled pair is one the gate rejects, so each pixel meets
//       its contributors in the same order with the same expressions:
//       rgb, T, done and last are the unculled walk's, bit for bit (K5
//       walks back from that last).  This is the TPU kernel's stop rule (a
//       pixel is done at the first candidate whose T_after falls below
//       t_min) evaluated sequentially instead of with a chunked cumprod.
//       Measured and dropped (PERF.md, section 6): the first design (one
//       256-thread block per 16 x 16 sub-tile, every pixel taking the gate
//       of every candidate, each candidate staged 16 times a 64-pixel
//       window), 5.2x slower at the fit's tier 2; the CUDA blocks of a
//       pixel block as a cluster staging each step once, each a share
//       pushed into every block's shared memory (one cluster barrier a
//       step, and the cluster leaves the window only when all its blocks
//       are done), 44% slower at tier 2.
//   K5: the reverse walk of csrc/reverse_walk.cuh over a candidate
//       window.  Each pixel block is a cluster of ceil(groups / 8) CUDA
//       blocks of 8 warps, one warp per 16 x 8 pixel group (4 blocks at B =
//       64: the fit's 40 tier-2 windows take 160 CUDA blocks, where one
//       1024-thread block per window kept 40 of the 132 SMs busy).  The
//       cluster walks back to front from its largest last contributor, 256
//       candidates staged per step with the box window_box derives from
//       their F rows; a warp walks only the staged candidates before its own
//       last contributor whose box meets its group, a lane only the pixels
//       inside the box (a culled pair is one the gate rejects).  Per pixel
//       it keeps T (recovered by division, T_before = T_after / (1 -
//       alpha)) and the suffix S of w (c . g_rgb) seeded with T_final g_T,
//       exactly the quantities of _blend_bwd_kernel.  Per candidate the 9
//       distinct sums over the block's pixels are stored only by warps that
//       reached it, then summed in a fixed order (the lanes by butterfly,
//       the warps in order, the cluster's blocks in rank order through
//       distributed shared memory): no global scratch, no atomics, and dF
//       is deterministic (the same windows give the same bits in K5 and
//       K9).  Each walked column of dF is written once, by one block of the
//       cluster; the columns past the walk get zeros, shared among them.
//   K8 / K9: the same two kernels on the packed addressing (window_of):
//       block b reads F columns offs[b] + j, walks n_live chunks of C like
//       the TPU kernels, and keeps its last-contributor index local to its
//       slice, as _blend_kernel_packed does; on the same windows K8 gives
//       K4's bits and K9 K5's.
// The power term is summed in the twin's order and this file is built with
// --fmad=false, so power and the gating decisions round as the twin's.

#include <cassert>

#include <cuda_runtime.h>

#include "reverse_walk.cuh"

namespace {

constexpr int CH = 256;            // candidates staged per forward step
constexpr int FWD_THREADS = rwalk::NW * 32;  // K4 / K8: 8 pixel groups
static_assert(FWD_THREADS == CH, "K4 stages one candidate per thread");
constexpr int NROW = 10;           // staged F rows: 0..6 and 8..10

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

// The box, in block-local pixels, outside which the candidate of F rows
// F[0..6] cannot pass the gate (power <= F6, alpha >= alpha_min), with the
// expressions of cuda_blend.window_boxes.  The conic is a = -2 F0, c = -2
// F3, b = -F5 (exact); the centre g solves M g = (F1, F4); the power's
// peak is the form evaluated at g (first-order insensitive to the solve's
// rounding), and the gate needs q(p - g) <= 2 k, k = peak - ln(alpha_min):
// half-extents sqrt(2 k c / det), sqrt(2 k a / det).  k is widened by 1e-3
// (expf) and 4e-6 of the magnitude of the power's terms over the block
// and at g (the rounding of F2 and of the sums), the extents by 0.1% and
// a pixel (the centre's rounding).  Empty for a dead column, a log opacity
// below ln(alpha_min) or k < 0; infinite for a conic that is not positive
// definite or is near-singular (det <= 1e-3 a c).
__device__ __forceinline__ void window_box(const float* F, int B,
                                           float log_amin, float* box) {
  const float inf = __int_as_float(0x7f800000);
  float xl = -inf, xh = inf, yl = -inf, yh = inf;
  const float a = -2.0f * F[0], c = -2.0f * F[3], bb = -F[5];
  const float det = a * c - bb * bb;
  if (!(F[6] - log_amin >= 0.0f)) {
    xl = inf;  // never passes (dead columns, NaN too)
  } else if (a > 0.0f && c > 0.0f && det > 1e-3f * (a * c)) {
    const float gx = (c * F[1] - bb * F[4]) / det;
    const float gy = (a * F[4] - bb * F[1]) / det;
    const float peak = rwalk::power_of(F[0], F[1], F[2], F[3], F[4], F[5],
                                       F[6], gx * gx, gx, gy * gy, gy,
                                       gx * gy);
    const float fb = (float)B;
    const float mag = fabsf(F[0] * (gx * gx)) + fabsf(F[1] * gx)
                      + fabsf(F[2]) + fabsf(F[3] * (gy * gy))
                      + fabsf(F[4] * gy) + fabsf(F[5] * (gx * gy))
                      + (fabsf(F[0]) + fabsf(F[3]) + fabsf(F[5])) * (fb * fb)
                      + (fabsf(F[1]) + fabsf(F[4])) * fb;
    const float k = peak - log_amin + 4e-6f * mag;
    if (!(k >= 0.0f)) {
      xl = inf;
    } else {
      const float ex = sqrtf(2.0f * k * c / det) * 1.001f + 1.0f;
      const float ey = sqrtf(2.0f * k * a / det) * 1.001f + 1.0f;
      xl = gx - ex; xh = gx + ex; yl = gy - ey; yh = gy + ey;
    }
  }
  box[0] = xl; box[1] = xh; box[2] = yl; box[3] = yh;
}

// staged rows of a candidate: F rows 0..6, colors (7..9), box (10..13)
constexpr int NS = 14;

// The F rows of window column j of step base into f (zeros past count)
__device__ __forceinline__ void load_rows(const float* __restrict__ Fb,
                                          size_t ld, int j, int count,
                                          float* f) {
#pragma unroll
  for (int r = 0; r < NROW; ++r)
    f[r] = j < count ? Fb[frow(r) * ld + j] : 0.0f;
}

// A lane's 4 pixels of its warp's 16 x 8 group and their blend state
struct FwdLane {
  float px, pxx, rx0, ry0;
  float py[rwalk::PPT], T[rwalk::PPT], cr[rwalk::PPT], cg[rwalk::PPT],
      cb[rwalk::PPT], last[rwalk::PPT];
  bool done[rwalk::PPT];
  bool live;  // the group lies in the block

  __device__ __forceinline__ bool all_done() const {
    bool d = true;
#pragma unroll
    for (int k = 0; k < rwalk::PPT; ++k) d = d && done[k];
    return d;
  }
};

__device__ __forceinline__ void fwd_lane(FwdLane& ln, int rect, int B,
                                         int lane) {
  const int rects_x = B / 16;
  ln.live = rect < rwalk::groups_of(B);
  const int rx0 = (rect % rects_x) * 16, ry0 = (rect / rects_x) * 8;
  ln.rx0 = (float)rx0;
  ln.ry0 = (float)ry0;
  ln.px = (float)(rx0 + (lane & 15));
  ln.pxx = ln.px * ln.px;
#pragma unroll
  for (int k = 0; k < rwalk::PPT; ++k) {
    ln.py[k] = (float)(ry0 + (lane >> 4) + 2 * k);
    ln.T[k] = 1.0f;
    ln.cr[k] = ln.cg[k] = ln.cb[k] = ln.last[k] = 0.0f;
    ln.done[k] = !ln.live;
  }
}

// The warp's walk of its listed candidates of one step, front to back: a
// lane skips a candidate whose box misses its pixel before the power and
// the exp, then takes the twin's gate and update per pixel.
__device__ __forceinline__ void fwd_walk(FwdLane& ln, float (*st)[CH],
                                         const unsigned char* list, int cnt,
                                         int base, float t_min,
                                         float alpha_min) {
  for (int e = 0; e < cnt; ++e) {
    const int j = list[e];
    if (ln.px < st[10][j] || ln.px > st[11][j]) continue;
    const float yl = st[12][j], yh = st[13][j];
    const float F0 = st[0][j], F1 = st[1][j], F2 = st[2][j];
    const float F3 = st[3][j], F4 = st[4][j], F5 = st[5][j];
    const float logo = st[6][j];
#pragma unroll
    for (int k = 0; k < rwalk::PPT; ++k) {
      const float py = ln.py[k];
      if (ln.done[k] || py < yl || py > yh) continue;
      const float power = rwalk::power_of(F0, F1, F2, F3, F4, F5, logo,
                                          ln.pxx, ln.px, py * py, py,
                                          ln.px * py);
      const float alpha = fminf(0.99f, expf(power));
      if (!(power <= logo && alpha >= alpha_min)) continue;
      const float T_after = ln.T[k] * (1.0f - alpha);
      if (T_after < t_min) { ln.done[k] = true; continue; }
      const float w = ln.T[k] * alpha;
      ln.cr[k] += st[7][j] * w;
      ln.cg[k] += st[8][j] * w;
      ln.cb[k] += st[9][j] * w;
      ln.T[k] = T_after;
      ln.last[k] = (float)(base + j + 1);
    }
  }
}

__device__ __forceinline__ void fwd_store(const FwdLane& ln, float* ob,
                                          int B, int lane) {
  if (!ln.live) return;
  const int P = B * B;
#pragma unroll
  for (int k = 0; k < rwalk::PPT; ++k) {
    float* o = ob + (int)ln.py[k] * B + (int)ln.px;
    o[0 * P] = ln.cr[k];
    o[1 * P] = ln.cg[k];
    o[2 * P] = ln.cb[k];
    o[3 * P] = ln.T[k];
    o[4 * P] = ln.done[k] ? 1.0f : 0.0f;
    o[5 * P] = ln.last[k];
    o[6 * P] = 0.0f;
    o[7 * P] = 0.0f;
  }
}

// K4 / K8: the CUDA blocks [b S, b S + S) of pixel block b, S =
// rwalk::blocks_per(B), each take 8 of its 16 x 8 pixel groups.
template <bool PACKED>
__global__ void __launch_bounds__(FWD_THREADS)
blend_fwd_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                 const float* __restrict__ F, float* __restrict__ out, int K,
                 int C, int n_chunks, int B, float t_min, float alpha_min) {
  __shared__ float st[NS][CH];
  __shared__ unsigned char list[rwalk::NW][CH];
  const int per = rwalk::blocks_per(B);
  const int b = blockIdx.x / per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FwdLane ln;
  fwd_lane(ln, (blockIdx.x % per) * rwalk::NW + warp, B, lane);
  const Window win = window_of<PACKED>(b, counts, offs, K, C, n_chunks);
  const float* Fb = F + win.col0;
  const int count = win.count;
  const float log_amin = logf(alpha_min) - 1e-3f;

  float f[NROW];  // this thread's candidate of the next step
  load_rows(Fb, win.ld, threadIdx.x, count, f);
  for (int base = 0; base < count; base += CH) {
    const bool mine = ln.all_done();
    // also the barrier after the last step's walk
    if (__syncthreads_and(mine)) break;
    const int n = min(CH, count - base);
    {
      float box[4];
      window_box(f, B, log_amin, box);
#pragma unroll
      for (int r = 0; r < NROW; ++r) st[r][threadIdx.x] = f[r];
#pragma unroll
      for (int r = 0; r < 4; ++r) st[NROW + r][threadIdx.x] = box[r];
    }
    __syncthreads();
    // the next step's rows load while this one is walked
    if (base + CH < count)
      load_rows(Fb, win.ld, base + CH + threadIdx.x, count, f);
    const int cnt = __all_sync(rwalk::FULL, mine)
                        ? 0
                        : rwalk::warp_list(st[10], st[11], st[12], st[13], n,
                                           ln.rx0, ln.ry0, list[warp], lane);
    fwd_walk(ln, st, list[warp], cnt, base, t_min, alpha_min);
  }
  fwd_store(ln, out + (size_t)b * 8 * B * B, B, lane);
}

constexpr int BWD_NS = NS;

template <bool PACKED>
__global__ void __launch_bounds__(rwalk::NW * 32, 2)
blend_bwd_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                 const float* __restrict__ F, const float* __restrict__ out,
                 const float* __restrict__ g, float* __restrict__ dF, int K,
                 int C, int n_chunks, int B, float alpha_min) {
  using Sh = rwalk::Shared<BWD_NS>;
  constexpr int CH = rwalk::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  cooperative_groups::cluster_group cl =
      cooperative_groups::this_cluster();
  const int nranks = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / nranks;
  const int P = B * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Window win = window_of<PACKED>(b, counts, offs, K, C, n_chunks);
  const int W = win.width;
  const size_t ld = win.ld;
  const float* Fb = F + win.col0;
  float* dFb = dF + win.col0;

  rwalk::Lane ln;
  rwalk::load_lane(ln, rank * rwalk::NW + warp, B,
                   out + (size_t)b * 8 * P, g + (size_t)b * 8 * P, lane);
  // candidates [0, top) hold every contributor of the block; the columns
  // past the steps walked only get zeros, each block of the cluster a share
  const int top = rwalk::cluster_top(cl, sh, ln, lane);
  const int steps = (top + CH - 1) / CH;
  for (int i = min(W, steps * CH) + rank * blockDim.x + threadIdx.x; i < W;
       i += nranks * blockDim.x)
    for (int r = 0; r < 16; ++r) dFb[r * ld + i] = 0.0f;
  const float log_amin = logf(alpha_min) - 1e-3f;

  for (int step = steps - 1; step >= 0; --step) {
    const int base = step * CH;
    const int n = min(CH, W - base);
    const int q = step & 1;  // this step's buffer of the block's sums
    // stage each candidate's rows and box
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float f[NROW];
#pragma unroll
      for (int r = 0; r < NROW; ++r) f[r] = Fb[frow(r) * ld + base + j];
      float box[4];
      window_box(f, B, log_amin, box);
#pragma unroll
      for (int r = 0; r < NROW; ++r) sh.st[r][j] = f[r];
#pragma unroll
      for (int r = 0; r < 4; ++r) sh.st[NROW + r][j] = box[r];
    }
    rwalk::clear_mask(sh, warp, lane);
    __syncthreads();
    const int count = rwalk::warp_list(sh.st[10], sh.st[11], sh.st[12],
                                       sh.st[13], min(n, ln.top - base),
                                       ln.rx0, ln.ry0, sh.list[warp], lane);
    for (int e = count - 1; e >= 0; --e) {
      const int j = sh.list[warp][e];
      float v[rwalk::NSUM];
#pragma unroll
      for (int r = 0; r < rwalk::NSUM; ++r) v[r] = 0.0f;
      bool any = false;
      if (ln.px >= sh.st[10][j] && ln.px <= sh.st[11][j]) {
        rwalk::Slot sl;
#pragma unroll
        for (int r = 0; r < 7; ++r) sl.F[r] = sh.st[r][j];
#pragma unroll
        for (int r = 0; r < 3; ++r) sl.c[r] = sh.st[7 + r][j];
        sl.gx = sl.gy = 0.0f;
        sl.yl = sh.st[12][j];
        sl.yh = sh.st[13][j];
        any = rwalk::walk_slot<false>(ln, base + j + 1, sl, alpha_min,
                                           v);
      }
      rwalk::warp_emit(sh, warp, lane, j, v, any);
    }
    __syncthreads();
    rwalk::block_sum(sh, n, q);
    cl.sync();
    // this block's slice of the step's columns, totalled over the cluster:
    // dF rows 0..5 the monomial sums, 6 the log opacity (= row 2's sum of
    // dpower), 8..10 the colors; 7 and 11..15 zero
    int j0, j1;
    rwalk::slice_of(cl, n, j0, j1);
    for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
      float t[rwalk::NSUM];
      rwalk::cluster_total(cl, sh, j, q, t);
      float* o = dFb + base + j;
      o[0 * ld] = t[0];
      o[1 * ld] = t[1];
      o[2 * ld] = t[2];
      o[3 * ld] = t[3];
      o[4 * ld] = t[4];
      o[5 * ld] = t[5];
      o[6 * ld] = t[2];
      o[7 * ld] = 0.0f;
      o[8 * ld] = t[6];
      o[9 * ld] = t[7];
      o[10 * ld] = t[8];
      for (int r = 11; r < 16; ++r) o[r * ld] = 0.0f;
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

int gsmpm_blend_fwd(const int* counts, const float* F, float* out, int nb,
                    int K, int B, float t_min, float alpha_min, void* stream) {
  if (nb <= 0) return cudaSuccess;
  blend_fwd_kernel<false><<<rwalk::grid_of(nb, B), FWD_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      counts, nullptr, F, out, K, 1, 0, B, t_min, alpha_min);
  return cudaGetLastError();
}

// CUDA blocks of a K4 / K8 launch over nb pixel blocks of edge B
int gsmpm_blend_fwd_blocks(int nb, int B) { return rwalk::grid_of(nb, B); }

// CUDA blocks of a K5 / K9 launch over nb pixel blocks of edge B
int gsmpm_blend_bwd_blocks(int nb, int B) { return rwalk::grid_of(nb, B); }

int gsmpm_blend_bwd(const float* F, const float* out, const float* g,
                    float* dF, int nb, int K, int B, float alpha_min,
                    void* stream) {
  if (nb <= 0) return cudaSuccess;
  return rwalk::launch<rwalk::Shared<BWD_NS>>(
      blend_bwd_kernel<false>, nb, B, static_cast<cudaStream_t>(stream),
      nullptr, nullptr, F, out, g, dF, K, 1, 0, B, alpha_min);
}

int gsmpm_blend_packed_fwd(const int* counts, const int* offs, const float* F,
                           float* out, int nb, int T, int C, int n_chunks,
                           int B, float t_min, float alpha_min,
                           void* stream) {
  if (nb <= 0) return cudaSuccess;
  blend_fwd_kernel<true><<<rwalk::grid_of(nb, B), FWD_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      counts, offs, F, out, T, C, n_chunks, B, t_min, alpha_min);
  return cudaGetLastError();
}

int gsmpm_blend_packed_bwd(const int* counts, const int* offs, const float* F,
                           const float* out, const float* g, float* dF,
                           int nb, int T, int C, int n_chunks, int B,
                           float alpha_min, void* stream) {
  if (nb <= 0) return cudaSuccess;
  return rwalk::launch<rwalk::Shared<BWD_NS>>(
      blend_bwd_kernel<true>, nb, B, static_cast<cudaStream_t>(stream),
      counts, offs, F, out, g, dF, T, C, n_chunks, B, alpha_min);
}

}  // extern "C"
