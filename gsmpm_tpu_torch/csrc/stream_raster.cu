// Sorted-segment stream blend (forward) for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel K3 of gsmpm_tpu/render/stream_raster.py:
//   _stream_fwd_kernel (launcher _stream_core)  -> gsmpm_stream_fwd
// Plain twin: gsmpm_tpu_torch/render/stream_raster.py stream_blend_ref.
//
// Inputs: splanes (9, L) depth-sorted stream (rows gx, gy, conic a, b, c,
// log opacity, r, g, b); bounds (nf+1,) int32, display block b owning slots
// [bounds[b], bounds[b+1]).  Output (nf, 8, B*B): rows 0..2 rgb, 3
// transmittance T, 4 done, 5 last contributing global slot + 1 (as float),
// 6..7 zero.  Every block is written, blocks with an empty segment too
// (rgb 0, T 1).
//
// What bounds it on this card.  Work depends on the data: each pixel
// evaluates the slots of its block's segment up to its last contributor
// once it is done, else to the segment's end.  Each (slot, pixel) pair takes
// at least 20 fp32 operations (6 mul + 6 add for the power term, exp, clamp,
// two compares, the transmittance and three color updates).  The bytes are
// small: the stream (36 B per slot, 30 MB at frame 0's 0.84 M slots) plus
// the 22 MB output.  So the bound is operations: (walked pairs x 20) / 67
// TFLOP/s, 75 us for frame 0's 2.50e8 pairs.  chip_smoke.py counts the
// pairs from each run's output.
//
// Design.  The TPU kernel walks a chunk-major grid from scalar-prefetched
// step tables and evaluates a chunk of slots against all 4096 block pixels
// as an MXU matmul with a log-depth cumulative product.  Here grid
// (nf, (B/16)^2) gives each 16x16-pixel sub-tile of a display block one
// 256-thread block, one pixel per thread; the block reads bounds itself,
// stages the segment in shared memory 256 slots (9 planes) at a time, and
// every thread composites its pixel sequentially front to back, which is
// exactly the stop rule of the TPU kernel (a pixel is done at the first
// slot whose T_after would fall below t_min; T_after decreases
// monotonically, so the chunked and the sequential forms agree up to
// rounding of the transmittance product).  The block leaves its segment
// as soon as __syncthreads_and(done) holds.  The power term is summed in
// the same monomial order as the twin, and this file is built with
// --fmad=false, so it rounds bit for bit like the twin's.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 pixels
constexpr int CH = 256;       // slots staged per step

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
        const float gx = sp[0][j] - x0, gy = sp[1][j] - y0;
        const float a = sp[2][j], bb = sp[3][j], c = sp[4][j];
        const float logo = sp[5][j];
        const float F0 = -0.5f * a;
        const float F1 = a * gx + bb * gy;
        const float F2 = -0.5f * (a * gx * gx + c * gy * gy) - bb * gx * gy;
        const float F3 = -0.5f * c;
        const float F4 = c * gy + bb * gx;
        const float F5 = -bb;
        float power = F0 * pxx;
        power = power + F1 * px;
        power = power + F2;
        power = power + F3 * pyy;
        power = power + F4 * py;
        power = power + F5 * pxy;
        power = power + logo;
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

}  // extern "C"
