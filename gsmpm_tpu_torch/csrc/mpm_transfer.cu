// Tiled MLS-MPM particle<->grid transfers for Hopper (sm_90a), fp32.
//
// Replaces the two Pallas TPU kernels of gsmpm_tpu/sim/pallas_mpm.py:
//   K1 _p2g_kernel (launcher p2g_tiled_pallas)  -> gsmpm_p2g_tiled
//   K2 _g2p_kernel (launcher g2p_tiled_pallas)  -> gsmpm_g2p_tiled
// Plain twins: gsmpm_tpu_torch/sim/tiles.py p2g_tiled_ref / g2p_tiled_ref.
//
// Data layouts are the JAX package's, unchanged:
//   q        (40, NP)  packed particle rows (tiles.py RX..RDRIFT), NP = nchunk*S
//   sig      (16, NP)  Kirchhoff stress rows 0..8 (row-major 3x3)
//   windows  (ntiles, 256, 64) P2G output: row oct*32 + comp*8 + xl,
//            col yl*8 + zl, oct = a*4 + b*2 + c; window slot i = a*8 + xl
//   ext      (ntiles, 192, 64) G2P input: row oct*24 + comp*8 + xl
//   chunk_tile (nchunk,) int32, non-decreasing (rebucket's order);
//   chunk_live (nchunk,) int32, 1 for chunks that hold real slots.
//
// What bounds them on this card (chip_smoke.py computes both bounds from
// each run's inputs; the figures here are the main path's: 245,760
// gaussians of which 196,730 are particles, n_grid 50, 343 tiles).
//   K1 must read 26 rows of each live slot (x, v, C, mass, vol and the 9
//   stress rows; 203,776 live slots) and write the windows (22.5 MB):
//   ~44 MB, 13 us at 3.35 TB/s.  ~1,260 flops per particle is 3.7 us at
//   67 TFLOP/s, so the bound is bytes.
//   K2 must read 18 rows of every slot (x and the copied rows: F, mass,
//   vol, yield, padding; 284,672 slots) and the occupied tiles' velocity
//   blocks, and write all 40 rows: ~69 MB, 21 us.  ~1,900 flops per
//   particle is 5.6 us, so the bound is bytes.
// What holds K1 back is not the bytes but 108 shared-memory float atomics
// per particle (27 nodes x 4 components).  With one block per tile (the
// port's first design) a dense scene put ~46 chunks of one tile through one
// block on one SM: the fit's 21 occupied tiles used 21 of 132 SMs.
//
// Design.  The TPU kernels expand the separable B-spline stencil into dense
// pair-table matmuls because the TPU has no scatter; a GPU has fast
// shared-memory atomics, so here each thread owns one particle and touches
// only its 27 stencil nodes.
//   K1: the TPU grid has one program per chunk, and so does this one:
//       one block per chunk (dead chunks return at once), so a dense tile
//       spreads over many SMs.  The launcher zeroes the windows; each live
//       chunk's block accumulates a private 4 x 16^3 window (64 KB of
//       dynamic shared memory, 3 blocks per SM) with shared atomicAdd,
//       then adds it into its tile's output window with float4 global
//       atomics (sm_90), skipping float4s that no particle reached.
//       Tiles without live chunks keep the zeros.  Writing per-chunk
//       partials to scratch and summing them per tile in chunk order in a
//       second pass was measured and dropped: 0.25 against 0.17 ms a
//       launch at the fit's shapes (PERF.md, section 6).
//       Summing the lanes of a warp that share a base cell by shuffles
//       before the atomics (one atomic per node and component) was
//       measured and dropped: it cost 3-21% at both shapes, the particles
//       of a tile being in random order (PERF.md, section 6).
//       Both the shared and the global atomics add in a run-dependent
//       order, so the kernel is NOT deterministic: results agree with the
//       twin to ~1e-6 of the window's largest entry, not bitwise, and may
//       differ in the last bits between runs.
//   K2: one block per chunk stages its tile's (192, 64) block (48 KB) in
//       shared memory; one thread per particle gathers its 27 nodes, then
//       writes every q row (advected x, v, C, F_trial, drift flag; other
//       rows copied).  Dead chunks copy q through.
// The domain clamp folds stencil slots as clip(torg + k, PAD_LO,
// PAD_LO + g - 1) - torg, the scatter form of the JAX _clamp_bases.

#include <cuda_runtime.h>

namespace {

constexpr int QROWS = 40;
constexpr int RX = 0, RV = 3, RC = 6, RF = 15, RFT = 24, RMASS = 33, RVOL = 34;
constexpr int RDRIFT = 36;
constexpr int T_TILE = 8, PAD_LO = 4;
constexpr int LOCAL_MIN = 0, LOCAL_MAX = 13, SAFE_MIN = 1, SAFE_MAX = 12;
constexpr int WIN_FLOATS = 256 * 64;   // P2G window: 4 comps x 16^3
constexpr int EXT_FLOATS = 192 * 64;   // G2P block: 3 comps x 16^3
constexpr int THREADS = 256;

struct Axis {
  int slot[3];     // folded window slot of stencil node k
  float w[3], dw[3], u[3];
};

// One axis of the quadratic B-spline stencil, as tiles._axis_bases.
__device__ __forceinline__ void axis_stencil(float x, int torg, float inv_dx,
                                             int g, Axis& a) {
  float gp = x * inv_dx;
  float basef = floorf(gp - 0.5f);
  float fx = gp - basef;
  int basep = (int)fminf(fmaxf(basef, -1.0f), (float)(g - 1)) + PAD_LO;
  int local = min(max(basep - torg, LOCAL_MIN), LOCAL_MAX);
  float t0 = 1.5f - fx, t1 = fx - 1.0f, t2 = fx - 0.5f;
  a.w[0] = 0.5f * (t0 * t0);
  a.w[1] = 0.75f - t1 * t1;
  a.w[2] = 0.5f * (t2 * t2);
  a.dw[0] = (fx - 1.5f) * inv_dx;
  a.dw[1] = -2.0f * t1 * inv_dx;
  a.dw[2] = t2 * inv_dx;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.u[k] = a.w[k] * ((float)k - fx);
    int s = local + k + torg;
    s = min(max(s, PAD_LO), PAD_LO + g - 1);
    a.slot[k] = s - torg;
  }
}

// The P2G window index of component 0 at window slot (i, j, k), row
// oct*32 + comp*8 + (i&7) and column (j&7)*8 + (k&7) with oct = (i>>3)*4 +
// (j>>3)*2 + (k>>3), is a sum of one term per axis; component comp adds
// comp * 8 * 64.
__device__ __forceinline__ int win_x(int i) { return (i >> 3) * 8192 + (i & 7) * 64; }
__device__ __forceinline__ int win_y(int j) { return (j >> 3) * 4096 + (j & 7) * 8; }
__device__ __forceinline__ int win_z(int k) { return (k >> 3) * 2048 + (k & 7); }

__device__ __forceinline__ int ext_index(int i, int j, int k, int comp) {
  int oct = (i >> 3) * 4 + (j >> 3) * 2 + (k >> 3);
  return ((oct * 24 + comp * 8 + (i & 7)) << 6) + ((j & 7) << 3) + (k & 7);
}

// ---- K1: one block per live chunk ---------------------------------------

__global__ void __launch_bounds__(THREADS, 3)
p2g_kernel(const float* __restrict__ q, const float* __restrict__ sig,
           const int* __restrict__ chunk_tile,
           const int* __restrict__ chunk_live, float* __restrict__ windows,
           int NP, int nt, int S, int g, float dx, float inv_dx, float dt) {
  extern __shared__ float win[];
  const int c = blockIdx.x;
  if (chunk_live[c] != 1) return;  // dead chunk: adds nothing
  const int t = chunk_tile[c];
  for (int i = threadIdx.x; i < WIN_FLOATS; i += THREADS) win[i] = 0.0f;
  const int tx = (t / (nt * nt)) * T_TILE;
  const int ty = ((t / nt) % nt) * T_TILE;
  const int tz = (t % nt) * T_TILE;
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += THREADS) {
    const int p = c * S + s;
    const float m = q[RMASS * NP + p];
    const float vol = q[RVOL * NP + p];
    if (m == 0.0f && vol == 0.0f) continue;  // padding slot: adds zeros
    Axis ax, ay, az;
    axis_stencil(q[(RX + 0) * NP + p], tx, inv_dx, g, ax);
    axis_stencil(q[(RX + 1) * NP + p], ty, inv_dx, g, ay);
    axis_stencil(q[(RX + 2) * NP + p], tz, inv_dx, g, az);
    const float mdx = m * dx;
    const float ndtv = -dt * vol;
    // per-axis factors of the three momentum terms: xr (the x-side factor
    // of the wy*wz group), yr of wx*wz, zr of wx*wy; per component r
    float xr[3][3], yr[3][3], zr[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float cv = m * q[(RV + r) * NP + p];
      float cc[3], cs[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        cc[k] = mdx * q[(RC + 3 * r + k) * NP + p];
        cs[k] = ndtv * sig[(3 * r + k) * NP + p];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xr[r][k] = cv * ax.w[k] + cc[0] * ax.u[k] + cs[0] * ax.dw[k];
        yr[r][k] = cc[1] * ay.u[k] + cs[1] * ay.dw[k];
        zr[r][k] = cc[2] * az.u[k] + cs[2] * az.dw[k];
      }
    }
    int ix[3], iy[3], iz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ix[k] = win_x(ax.slot[k]);
      iy[k] = win_y(ay.slot[k]);
      iz[k] = win_z(az.slot[k]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int cz = 0; cz < 3; ++cz) {
          const float wyz = ay.w[b] * az.w[cz];
          const float wxz = ax.w[a] * az.w[cz];
          const float wxy = ax.w[a] * ay.w[b];
          const int base = ix[a] + iy[b] + iz[cz];
          atomicAdd(&win[base], m * (ax.w[a] * wyz));
#pragma unroll
          for (int r = 0; r < 3; ++r)
            atomicAdd(&win[base + (r + 1) * 8 * 64],
                      wyz * xr[r][a] + wxz * yr[r][b] + wxy * zr[r][cz]);
        }
      }
    }
  }
  __syncthreads();
  // add the window into the tile's output (zeroed by the launcher); a
  // float4 of zeros, where no particle of the chunk reached, is skipped
  float4* out = reinterpret_cast<float4*>(windows + (size_t)t * WIN_FLOATS);
  const float4* src = reinterpret_cast<const float4*>(win);
  for (int i = threadIdx.x; i < WIN_FLOATS / 4; i += THREADS) {
    const float4 v = src[i];
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
      atomicAdd(out + i, v);
  }
}

__global__ void __launch_bounds__(THREADS)
g2p_kernel(const float* __restrict__ q, const float* __restrict__ ext,
           const int* __restrict__ chunk_tile,
           const int* __restrict__ chunk_live, float* __restrict__ q_out,
           int NP, int nt, int S, int g, float inv_dx, float dt) {
  extern __shared__ float blk[];
  const int c = blockIdx.x;
  if (chunk_live[c] != 1) {  // dead chunk: pass q through
    for (int i = threadIdx.x; i < QROWS * S; i += THREADS) {
      const int row = i / S, p = c * S + i % S;
      q_out[(size_t)row * NP + p] = q[(size_t)row * NP + p];
    }
    return;
  }
  const int t = chunk_tile[c];
  const float4* src = reinterpret_cast<const float4*>(ext + (size_t)t * EXT_FLOATS);
  float4* dst = reinterpret_cast<float4*>(blk);
  for (int i = threadIdx.x; i < EXT_FLOATS / 4; i += THREADS) dst[i] = src[i];
  const int torg[3] = {(t / (nt * nt)) * T_TILE, ((t / nt) % nt) * T_TILE,
                       (t % nt) * T_TILE};
  __syncthreads();

  const float coef = 4.0f * inv_dx;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const int p = c * S + s;
    float x[3];
    Axis ax[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[d] = q[(RX + d) * NP + p];
      axis_stencil(x[d], torg[d], inv_dx, g, ax[d]);
    }
    float v[3] = {0.f, 0.f, 0.f};
    float grad[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float Cn[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int cz = 0; cz < 3; ++cz) {
          const float wyz = ax[1].w[b] * ax[2].w[cz];
          const float wxz = ax[0].w[a] * ax[2].w[cz];
          const float wxy = ax[0].w[a] * ax[1].w[b];
          const float w = ax[0].w[a] * wyz;
          const int base = ext_index(ax[0].slot[a], ax[1].slot[b], ax[2].slot[cz], 0);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float G = blk[base + r * 8 * 64];
            v[r] += w * G;
            grad[r][0] += ax[0].dw[a] * wyz * G;
            grad[r][1] += ax[1].dw[b] * wxz * G;
            grad[r][2] += ax[2].dw[cz] * wxy * G;
            Cn[r][0] += ax[0].u[a] * wyz * G;
            Cn[r][1] += ax[1].u[b] * wxz * G;
            Cn[r][2] += ax[2].u[cz] * wxy * G;
          }
        }
      }
    }
    const bool valid = q[RMASS * NP + p] > 0.0f;
    bool drift = false;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float nx = valid ? x[d] + dt * v[d] : x[d];
      q_out[(RX + d) * NP + p] = nx;
      q_out[(RV + d) * NP + p] = valid ? v[d] : 0.0f;
      const float gp = nx * inv_dx;
      const int basep =
          (int)fminf(fmaxf(floorf(gp - 0.5f), -1.0f), (float)(g - 1)) + PAD_LO;
      const int local = basep - torg[d];
      drift = drift || local < SAFE_MIN || local > SAFE_MAX;
    }
    float F[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) F[i] = q[(RF + i) * NP + p];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        q_out[(RC + 3 * r + cc) * NP + p] = valid ? coef * Cn[r][cc] : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float gk = grad[r][k] * dt + (k == r ? 1.0f : 0.0f);
          acc += gk * F[3 * k + cc];
        }
        q_out[(RFT + 3 * r + cc) * NP + p] = valid ? acc : F[3 * r + cc];
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) q_out[(RF + i) * NP + p] = F[i];
    q_out[RDRIFT * NP + p] = (valid && drift) ? 1.0f : 0.0f;
    for (int row = RMASS; row < QROWS; ++row)
      if (row != RDRIFT) q_out[(size_t)row * NP + p] = q[(size_t)row * NP + p];
  }
}

}  // namespace

extern "C" {

const char* gsmpm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// windows: (ntiles, 256, 64), zeroed here, then each live chunk's block
// adds its window into its tile's.
int gsmpm_p2g_tiled(const float* q, const float* sig, const int* chunk_tile,
                    const int* chunk_live, float* windows, int NP,
                    int nchunk, int ntiles, int nt, int S, int g, float dx,
                    float inv_dx, float dt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      windows, 0, (size_t)ntiles * WIN_FLOATS * sizeof(float), st);
  if (err != cudaSuccess) return err;
  const int smem = WIN_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(
      p2g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(p2g_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  p2g_kernel<<<nchunk, THREADS, smem, st>>>(
      q, sig, chunk_tile, chunk_live, windows, NP, nt, S, g, dx, inv_dx, dt);
  return cudaGetLastError();
}

int gsmpm_g2p_tiled(const float* q, const float* ext, const int* chunk_tile,
                    const int* chunk_live, float* q_out, int NP, int nchunk,
                    int nt, int S, int g, float inv_dx, float dt,
                    void* stream) {
  const int smem = EXT_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      g2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  g2p_kernel<<<nchunk, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, ext, chunk_tile, chunk_live, q_out, NP, nt, S, g, inv_dx, dt);
  return cudaGetLastError();
}

}  // extern "C"
