// Second-order basis reductions of the transfer VJPs, Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel K6 of gsmpm_tpu/sim/pallas_mpm.py:
//   _sored_kernel (launcher sored_tiled_pallas)  -> gsmpm_sored_tiled
// Plain twin: gsmpm_tpu_torch/sim/transfer_vjp.py sored_tiled_ref.
//
// For every particle slot p of chunk c (tile t = chunk_tile[c]) and window
// component cc it computes the 21 reductions of the tile's window planes
// against d/dx_a of the stencil basis products:
//   row 21cc + a            <win_cc, d_a W>         W   = w w w
//   row 21cc + 3 + 3a + k   <win_cc, d_a U^k>       U^k = w w w, u on axis k
//   row 21cc + 12 + 3a + k  <win_cc, d_a D^k>       D^k = w w w, dw on axis k
// with per-axis bases w, dw, u = w (k - fx), ddw = {1, -2, 1} inv_dx^2 and
// du = dw (k - fx) - w inv_dx.  Layouts are the JAX package's:
//   q           (40, NP)             rows 0..2 position (grid coords)
//   win_planes  (ntiles, 3*16, 256)  [cc][i][(b*2+c)*64 + yl*8 + zl],
//               window cell (i, j, k) = (i, b*8+yl, c*8+zl)
//   out         (64, NP)             row 63 and dead chunks: 0
//
// What bounds it on this card (chip_smoke.py computes both from each run's
// inputs).  Bytes: 3 position rows of the live slots, the occupied tiles'
// planes and the 64 output rows of every slot (~89 MB at the fit path's
// NP 333,568, ~27 us at 3.35 TB/s).  Operations: per real particle and
// component, 27 stencil nodes x 30 flops (two window products and 12 pair
// updates) plus 3 x 21 multiply-adds: ~2,800 flops per particle, ~0.7
// GFLOP, ~11 us at 67 TFLOP/s.  So the bytes bound it.
//
// Design.  The TPU kernel expands each basis into dense 16-slot axes and
// contracts pair tables on the MXU.  Here one block per chunk stages the
// tile's planes (48 KB for 3 components) in shared memory and one thread
// per particle visits only its 27 stencil nodes: for each x node it sums
// the 12 (y, z) pair products of the window over the 9 (y, z) nodes, then
// combines them with the 5 x bases.  Out-of-domain stencil nodes fold onto
// the boundary cells exactly as the forward kernels fold them
// (mpm_transfer.cu axis_stencil), which equals the twin's folding matrix.

#include <cuda_runtime.h>

namespace {

constexpr int RX = 0;
constexpr int T_TILE = 8, PAD_LO = 4;
constexpr int LOCAL_MIN = 0, LOCAL_MAX = 13;
constexpr int PLANE = 16 * 256;  // floats per component plane
constexpr int NCOMP = 3;         // window components (velocities)
constexpr int THREADS = 256;
constexpr int OUT_ROWS = 64;

struct Axis2 {
  int slot[3];
  float w[3], dw[3], u[3], ddw[3], du[3];
};

__device__ __forceinline__ void axis_bases2(float x, int torg, float inv_dx,
                                            int g, Axis2& a) {
  const float gp = x * inv_dx;
  const float basef = floorf(gp - 0.5f);
  const float fx = gp - basef;
  const int basep = (int)fminf(fmaxf(basef, -1.0f), (float)(g - 1)) + PAD_LO;
  const int local = min(max(basep - torg, LOCAL_MIN), LOCAL_MAX);
  const float t0 = 1.5f - fx, t1 = fx - 1.0f, t2 = fx - 0.5f;
  a.w[0] = 0.5f * (t0 * t0);
  a.w[1] = 0.75f - t1 * t1;
  a.w[2] = 0.5f * (t2 * t2);
  a.dw[0] = (fx - 1.5f) * inv_dx;
  a.dw[1] = -2.0f * t1 * inv_dx;
  a.dw[2] = t2 * inv_dx;
  const float dd = inv_dx * inv_dx;
  a.ddw[0] = dd;
  a.ddw[1] = -2.0f * dd;
  a.ddw[2] = dd;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float kf = (float)k - fx;
    a.u[k] = a.w[k] * kf;
    a.du[k] = a.dw[k] * kf - a.w[k] * inv_dx;
    int s = local + k + torg;
    s = min(max(s, PAD_LO), PAD_LO + g - 1);
    a.slot[k] = s - torg;
  }
}

__global__ void __launch_bounds__(THREADS)
sored_kernel(const float* __restrict__ q, const float* __restrict__ planes,
             const int* __restrict__ chunk_tile,
             const int* __restrict__ chunk_live, float* __restrict__ out,
             int NP, int nt, int S, int g, float inv_dx) {
  extern __shared__ float win[];
  const int c = blockIdx.x;
  if (chunk_live[c] != 1) {  // dead chunk: zeros
    for (int i = threadIdx.x; i < OUT_ROWS * S; i += THREADS)
      out[(size_t)(i / S) * NP + (size_t)c * S + i % S] = 0.0f;
    return;
  }
  const int t = chunk_tile[c];
  const int nfl = NCOMP * PLANE;
  const float4* src = reinterpret_cast<const float4*>(planes + (size_t)t * nfl);
  float4* dst = reinterpret_cast<float4*>(win);
  for (int i = threadIdx.x; i < nfl / 4; i += THREADS) dst[i] = src[i];
  const int torg[3] = {(t / (nt * nt)) * T_TILE, ((t / nt) % nt) * T_TILE,
                       (t % nt) * T_TILE};
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += THREADS) {
    const size_t p = (size_t)c * S + s;
    Axis2 X, Y, Z;
    axis_bases2(q[(RX + 0) * (size_t)NP + p], torg[0], inv_dx, g, X);
    axis_bases2(q[(RX + 1) * (size_t)NP + p], torg[1], inv_dx, g, Y);
    axis_bases2(q[(RX + 2) * (size_t)NP + p], torg[2], inv_dx, g, Z);
    int col[3][3];
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int cz = 0; cz < 3; ++cz) {
        const int sy = Y.slot[b], sz = Z.slot[cz];
        col[b][cz] = (((sy >> 3) * 2 + (sz >> 3)) << 6) + ((sy & 7) << 3)
                     + (sz & 7);
      }
    for (int cc = 0; cc < NCOMP; ++cc) {
      float r[21];
#pragma unroll
      for (int i = 0; i < 21; ++i) r[i] = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* row = win + cc * PLANE + X.slot[a] * 256;
        // pair sums over the 9 (y, z) nodes: ww dw wd uw wu Du ud du_ uD
        // ad dd da (y basis first)
        float P[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) P[i] = 0.0f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int cz = 0; cz < 3; ++cz) {
            const float G = row[col[b][cz]];
            const float gwz = G * Z.w[cz], gdz = G * Z.dw[cz];
            P[0] += Y.w[b] * gwz;
            P[1] += Y.dw[b] * gwz;
            P[2] += Y.w[b] * gdz;
            P[3] += Y.u[b] * gwz;
            P[4] += Y.w[b] * (G * Z.u[cz]);
            P[5] += Y.du[b] * gwz;
            P[6] += Y.u[b] * gdz;
            P[7] += Y.dw[b] * (G * Z.u[cz]);
            P[8] += Y.w[b] * (G * Z.du[cz]);
            P[9] += Y.ddw[b] * gwz;
            P[10] += Y.dw[b] * gdz;
            P[11] += Y.w[b] * (G * Z.ddw[cz]);
          }
        }
        const float xw = X.w[a], xd = X.dw[a], xu = X.u[a];
        const float xdd = X.ddw[a], xdu = X.du[a];
        // d_a W
        r[0] += xd * P[0];
        r[1] += xw * P[1];
        r[2] += xw * P[2];
        // d_a U^k, row 3 + 3a + k
        r[3] += xdu * P[0];
        r[4] += xd * P[3];
        r[5] += xd * P[4];
        r[6] += xu * P[1];
        r[7] += xw * P[5];
        r[8] += xw * P[7];
        r[9] += xu * P[2];
        r[10] += xw * P[6];
        r[11] += xw * P[8];
        // d_a D^k, row 12 + 3a + k
        r[12] += xdd * P[0];
        r[13] += xd * P[1];
        r[14] += xd * P[2];
        r[15] += xd * P[1];
        r[16] += xw * P[9];
        r[17] += xw * P[10];
        r[18] += xd * P[2];
        r[19] += xw * P[10];
        r[20] += xw * P[11];
      }
#pragma unroll
      for (int i = 0; i < 21; ++i) out[(size_t)(21 * cc + i) * NP + p] = r[i];
    }
    for (int i = 21 * NCOMP; i < OUT_ROWS; ++i) out[(size_t)i * NP + p] = 0.0f;
  }
}

}  // namespace

extern "C" {

const char* gsmpm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gsmpm_sored_tiled(const float* q, const float* planes,
                      const int* chunk_tile, const int* chunk_live, float* out,
                      int NP, int nchunk, int nt, int S, int g, float inv_dx,
                      void* stream) {
  const int smem = NCOMP * PLANE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sored_kernel<<<nchunk, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, planes, chunk_tile, chunk_live, out, NP, nt, S, g, inv_dx);
  return cudaGetLastError();
}

}  // extern "C"
