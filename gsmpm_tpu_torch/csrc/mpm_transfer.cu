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
//   particle (the 27-node form's count) is 5.6 us, so the bound is bytes.
// What holds K1 back is not the bytes but 108 shared-memory float atomics
// per particle (27 nodes x 4 components).  With one block per tile (the
// port's first design) a dense scene put ~46 chunks of one tile through one
// block on one SM: the fit's 21 occupied tiles used 21 of 132 SMs.
// What held K2 back was neither the bytes nor the staging: its first
// design (a block per chunk copying its tile's 48 KB block into shared
// memory through registers) used 251 registers a thread, so one 256-thread
// block ran per SM and nothing hid the latency of the copy, the gathers
// and the row loads and stores (PERF.md, section 6).
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
//   K2: one 256-thread block per two consecutive chunks, two blocks an SM
//       (127 registers a thread, no spills).  The chunks of a tile are
//       consecutive (chunk_tile is non-decreasing), so a block bulk-copies
//       its tile's (192, 64) block (48 KB) into shared memory once with
//       cp.async.bulk on an mbarrier (again only where the tile changes),
//       and each thread forms its particle's stencils while the copy is
//       in flight.  One thread per particle then gathers its 27 nodes as a
//       separable contraction (over z, then y, then x, per component) and
//       writes every q row (advected x, v, C, F_trial, drift flag; other
//       rows copied).  Dead chunks pass q through with float4 copies.
//       Measured and dropped (PERF.md, section 6): gathers from global
//       memory through L1 without staging (no faster than staging per
//       chunk: a chunk's particles are in random order, so a warp's
//       gather touches up to 32 lines), 4 or 8 chunks a block (too few
//       blocks to fill the card), a cap of 80 or 64 registers (spills),
//       loading the F and copied rows before the copy lands (more
//       registers; slower with the separable form), and the 27-node sum
//       at 128 registers (3-8% slower than the separable form).
// The domain clamp folds stencil slots as clip(torg + k, PAD_LO,
// PAD_LO + g - 1) - torg, the scatter form of the JAX _clamp_bases.

#include <cstdint>

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

// The same for the G2P block's rows oct*24 + comp*8 + (i&7); component comp
// adds comp * 8 * 64.
__device__ __forceinline__ int ext_x(int i) { return (i >> 3) * 6144 + (i & 7) * 64; }
__device__ __forceinline__ int ext_y(int j) { return (j >> 3) * 3072 + (j & 7) * 8; }
__device__ __forceinline__ int ext_z(int k) { return (k >> 3) * 1536 + (k & 7); }

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

// ---- K2: a block per two chunks, its tile's block bulk-copied once -------

constexpr int G2P_RUN = 2;  // chunks a K2 block takes

// A slot's position and stencils, formed while its tile's block lands
struct G2PSlot {
  float x[3];
  Axis ax[3];
};

// The separable gathers of slot p from blk, its tile's (192, 64) block in
// shared memory, then every q row of it.  Per component the 27 nodes are
// contracted over z, then y, then x (147 multiply-adds where the 27-node
// sum takes 567 and 270 weight products), axis_stencil's dw and u are
// formed from the fraction fx where they are used, and the APIC rows are
// written per component: 127 registers, two blocks an SM.
__device__ __forceinline__ void g2p_slot(const G2PSlot& s,
                                         const float* __restrict__ blk,
                                         const float* __restrict__ q,
                                         float* __restrict__ q_out, int p,
                                         int NP, const int* torg, int g,
                                         float inv_dx, float dt) {
  const Axis* ax = s.ax;
  int off[3][3];  // the block index's term of stencil node k per axis
  float fx[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    off[0][k] = ext_x(ax[0].slot[k]);
    off[1][k] = ext_y(ax[1].slot[k]);
    off[2][k] = ext_z(ax[2].slot[k]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float gp = s.x[d] * inv_dx;
    fx[d] = gp - floorf(gp - 0.5f);
  }
  // axis_stencil's dw and u of node k along axis d
  auto dw = [&](int d, int k) {
    return k == 0 ? (fx[d] - 1.5f) * inv_dx
                  : (k == 1 ? -2.0f * (fx[d] - 1.0f) * inv_dx
                            : (fx[d] - 0.5f) * inv_dx);
  };
  auto uu = [&](int d, int k) { return ax[d].w[k] * ((float)k - fx[d]); };
  const float coef = 4.0f * inv_dx;
  const bool valid = q[RMASS * NP + p] > 0.0f;
  float v[3], grad[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float fv = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f, c0 = 0.f, c1 = 0.f,
          c2 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float yww = 0.f, ydw = 0.f, yuw = 0.f, ywd = 0.f, ywu = 0.f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float zw = 0.f, zd = 0.f, zu = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float G = blk[off[0][a] + off[1][b] + off[2][c] + r * 512];
          zw += ax[2].w[c] * G;
          zd += dw(2, c) * G;
          zu += uu(2, c) * G;
        }
        yww += ax[1].w[b] * zw;
        ydw += dw(1, b) * zw;
        yuw += uu(1, b) * zw;
        ywd += ax[1].w[b] * zd;
        ywu += ax[1].w[b] * zu;
      }
      fv += ax[0].w[a] * yww;
      g0 += dw(0, a) * yww;
      c0 += uu(0, a) * yww;
      g1 += ax[0].w[a] * ydw;
      c1 += ax[0].w[a] * yuw;
      g2 += ax[0].w[a] * ywd;
      c2 += ax[0].w[a] * ywu;
    }
    v[r] = fv;
    grad[r][0] = g0;
    grad[r][1] = g1;
    grad[r][2] = g2;
    q_out[(RC + 3 * r + 0) * NP + p] = valid ? coef * c0 : 0.0f;
    q_out[(RC + 3 * r + 1) * NP + p] = valid ? coef * c1 : 0.0f;
    q_out[(RC + 3 * r + 2) * NP + p] = valid ? coef * c2 : 0.0f;
  }
  bool drift = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float nx = valid ? s.x[d] + dt * v[d] : s.x[d];
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

// A dead chunk's 40 rows passed through, 16 bytes a thread (S % 4 == 0)
__device__ __forceinline__ void g2p_pass(const float* __restrict__ q,
                                         float* __restrict__ q_out, int c,
                                         int NP, int S) {
  const int S4 = S / 4;
  for (int i = threadIdx.x; i < QROWS * S4; i += blockDim.x) {
    const int row = i / S4, k = i % S4;
    const size_t off = (size_t)row * NP + (size_t)c * S;
    reinterpret_cast<float4*>(q_out + off)[k] =
        reinterpret_cast<const float4*>(q + off)[k];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: expect `bytes` on bar and bulk-copy them (TMA) from src
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  }
}

// Block i takes chunks [i G2P_RUN, i G2P_RUN + G2P_RUN).
__global__ void __launch_bounds__(THREADS, 2)
g2p_kernel(const float* __restrict__ q, const float* __restrict__ ext,
           const int* __restrict__ chunk_tile,
           const int* __restrict__ chunk_live, float* __restrict__ q_out,
           int NP, int nchunk, int nt, int S, int g, float inv_dx,
           float dt) {
  extern __shared__ __align__(128) float blk[];
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  int staged = -1;  // the tile whose block blk holds
  unsigned phase = 0;
  const int c0 = blockIdx.x * G2P_RUN, c1 = min(c0 + G2P_RUN, nchunk);
  for (int c = c0; c < c1; ++c) {
    if (chunk_live[c] != 1) {  // dead chunk: pass q through
      g2p_pass(q, q_out, c, NP, S);
      continue;
    }
    const int t = chunk_tile[c];
    const int torg[3] = {(t / (nt * nt)) * T_TILE, ((t / nt) % nt) * T_TILE,
                         (t % nt) * T_TILE};
    const bool fresh = t != staged;
    if (fresh) {
      __syncthreads();  // every gather from the last tile's block is done
      if (threadIdx.x == 0)
        bulk_load(blk, ext + (size_t)t * EXT_FLOATS,
                  EXT_FLOATS * sizeof(float), &bar);
    }
    for (int s = threadIdx.x; s < S; s += THREADS) {
      const int p = c * S + s;
      G2PSlot sl;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        sl.x[d] = q[(RX + d) * NP + p];
        axis_stencil(sl.x[d], torg[d], inv_dx, g, sl.ax[d]);
      }
      if (fresh) mbar_wait(&bar, phase);  // the copy landed meanwhile
      g2p_slot(sl, blk, q, q_out, p, NP, torg, g, inv_dx, dt);
    }
    if (fresh) {
      phase ^= 1u;
      staged = t;
    }
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

// CUDA blocks of a K2 launch over nchunk chunks
int gsmpm_g2p_blocks(int nchunk) {
  return (nchunk + G2P_RUN - 1) / G2P_RUN;
}

// The chunks of a tile are consecutive (chunk_tile is non-decreasing), so a
// block's two chunks mostly share one bulk copy.
int gsmpm_g2p_tiled(const float* q, const float* ext, const int* chunk_tile,
                    const int* chunk_live, float* q_out, int NP, int nchunk,
                    int nt, int S, int g, float inv_dx, float dt,
                    void* stream) {
  // 16-byte rows for the bulk copy and the dead chunks' float4 copies
  if (S % 4 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0
      || reinterpret_cast<uintptr_t>(q_out) % 16 != 0
      || reinterpret_cast<uintptr_t>(ext) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int smem = EXT_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      g2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  g2p_kernel<<<gsmpm_g2p_blocks(nchunk), THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
      q, ext, chunk_tile, chunk_live, q_out, NP, nchunk, nt, S, g, inv_dx,
      dt);
  return cudaGetLastError();
}

}  // extern "C"
