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
// NP 333,568, ~27 us at 3.35 TB/s).  Operations: ~2,800 flops per real
// particle as the twin counts them, ~11 us at 67 TFLOP/s.  So the bytes
// bound it, and 85 MB of them are the output rows: the kernel is a stream
// of stores with arithmetic in between.
//
// Design.  The TPU kernel expands each basis into dense 16-slot axes and
// contracts pair tables on the MXU.  Here one thread per particle visits
// only its 27 stencil nodes in the tile's planes, staged in shared memory
// (48 KB for 3 components), and everything else serves the store stream:
// - A persistent grid of as many CTAs as fit on the card at once (the
//   occupancy, computed once per device and cached: 2 a SM at 128
//   registers and 96 KB).  CTA i takes chunks i, i + n, i + 2n, ... of
//   the n CTAs, so the CTAs in flight write neighbouring chunks of each
//   output row, and a live prefix (every caller's: tiles.rebucket) splits
//   evenly without counting it.  No work counter, nothing to reset between
//   CUDA graph replays, no atomics.
// - Each CTA walks its chunks from the last, so the dead tail's zero
//   stores (float4) run while its first tile lands.  One thread stages a
//   tile's planes with bulk asynchronous copies (cp.async.bulk, completion
//   on an mbarrier) into one of two buffers: the next live chunk's tile
//   lands while the current chunk computes, and a tile already in a buffer
//   is not copied again.
// - Streaming stores (st.global.cs, evict first): the 85 MB of rows
//   outgrow the 50 MB L2 anyway, and on the card these stores drain
//   faster than plain ones (PERF.md, Findings).
// - Separable contractions: per (y, z) node the three x nodes are
//   contracted against the 5 x bases, then the 12 (x, z) basis pairs over
//   z, then the 18 distinct (x, y, z) triples over y: 297 FMAs per particle
//   and component, against 522 for the 12 (y, z) pair sums per x node.
// Every output element is written by one thread in a fixed order, so
// reruns give the same bits.  Out-of-domain stencil nodes fold onto the
// boundary cells exactly as the forward kernels fold them
// (mpm_transfer.cu axis_stencil), which equals the twin's folding matrix.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RX = 0;
constexpr int T_TILE = 8, PAD_LO = 4;
constexpr int LOCAL_MIN = 0, LOCAL_MAX = 13;
constexpr int PLANE = 16 * 256;          // floats per component plane
constexpr int NCOMP = 3;                 // window components (velocities)
constexpr int TILE_FLOATS = NCOMP * PLANE;
constexpr int TILE_BYTES = TILE_FLOATS * 4;  // 48 KB
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS_PER_SM = 2;
constexpr int OUT_ROWS = 64;
constexpr int SMEM_BYTES = 2 * TILE_BYTES;  // two tile buffers
constexpr uint64_t WAIT_LIMIT_NS = 10000000000ull;  // 10 s

struct Axis {
  int slot[3];
  float w[3], dw[3], u[3], du[3];
};

__device__ __forceinline__ void axis_bases(float x, int torg, float inv_dx,
                                           int g, Axis& a) {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: expect a tile's bytes on bar, then copy the 3 component
// planes (16 KB each) into buf with bulk asynchronous copies.
__device__ __forceinline__ void stage_tile(float* buf, uint64_t* bar,
                                           const float* src) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(TILE_BYTES) : "memory");
#pragma unroll
  for (int cc = 0; cc < NCOMP; ++cc)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(buf + cc * PLANE)), "l"(src + cc * PLANE),
           "r"(PLANE * 4), "r"(b) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for a tile's copy; a copy that never lands (a fault) aborts the
// launch with an error after WAIT_LIMIT_NS instead of hanging the card.
__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  const uint64_t t0 = global_ns();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
    if (!done && global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  } while (!done);
}

// All 64 rows of chunk c are zero (a dead chunk).
__device__ __forceinline__ void zero_chunk(float* __restrict__ out, int c,
                                           int NP, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t c0 = (size_t)c * S;
  if (((NP | S) & 3) == 0) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = warp; r < OUT_ROWS; r += WARPS) {
      float4* row = reinterpret_cast<float4*>(out + (size_t)r * NP + c0);
      for (int k = lane; k < S / 4; k += 32) __stcs(row + k, z);
    }
  } else {
    for (int r = warp; r < OUT_ROWS; r += WARPS)
      for (int k = lane; k < S; k += 32)
        __stcs(out + (size_t)r * NP + c0 + k, 0.0f);
  }
}

// The 64 rows of particle slot p against the tile planes in win.
__device__ __forceinline__ void reduce_slot(const float* __restrict__ win,
                                            const float* __restrict__ q,
                                            float* __restrict__ out,
                                            size_t p, int NP,
                                            const int torg[3], int g,
                                            float inv_dx) {
  Axis X, Y, Z;
  axis_bases(q[(RX + 0) * (size_t)NP + p], torg[0], inv_dx, g, X);
  axis_bases(q[(RX + 1) * (size_t)NP + p], torg[1], inv_dx, g, Y);
  axis_bases(q[(RX + 2) * (size_t)NP + p], torg[2], inv_dx, g, Z);
  const float dd = inv_dx * inv_dx;
  const float ddw[3] = {dd, -2.0f * dd, dd};
  int col[3][3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int cz = 0; cz < 3; ++cz) {
      const int sy = Y.slot[b], sz = Z.slot[cz];
      col[b][cz] = (((sy >> 3) * 2 + (sz >> 3)) << 6) + ((sy & 7) << 3)
                   + (sz & 7);
    }
  const int xo[3] = {X.slot[0] * 256, X.slot[1] * 256, X.slot[2] * 256};

#pragma unroll 1
  for (int cc = 0; cc < NCOMP; ++cc) {
    const float* pl = win + cc * PLANE;
    // the 18 distinct (x, y, z) basis triples, named by kind per axis:
    // w, d (dw), u, D (du), a (ddw)
    float dww = 0.f, wdw = 0.f, wwd = 0.f, Dww = 0.f, duw = 0.f, dwu = 0.f,
          udw = 0.f, wDw = 0.f, wdu = 0.f, uwd = 0.f, wud = 0.f, wwD = 0.f,
          aww = 0.f, ddw_ = 0.f, dwd = 0.f, waw = 0.f, wdd = 0.f, wwa = 0.f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      // (x, z) pair sums over the 3 z nodes
      float e_dw = 0.f, e_ww = 0.f, e_wd = 0.f, e_Dw = 0.f, e_du = 0.f,
            e_uw = 0.f, e_wu = 0.f, e_ud = 0.f, e_wD = 0.f, e_aw = 0.f,
            e_dd = 0.f, e_wa = 0.f;
#pragma unroll
      for (int cz = 0; cz < 3; ++cz) {
        const int cl = col[b][cz];
        const float g0 = pl[xo[0] + cl], g1 = pl[xo[1] + cl],
                    g2 = pl[xo[2] + cl];
        // the 3 x nodes against the 5 x bases
        const float xw = X.w[0] * g0 + X.w[1] * g1 + X.w[2] * g2;
        const float xd = X.dw[0] * g0 + X.dw[1] * g1 + X.dw[2] * g2;
        const float xu = X.u[0] * g0 + X.u[1] * g1 + X.u[2] * g2;
        const float xD = X.du[0] * g0 + X.du[1] * g1 + X.du[2] * g2;
        const float xa = dd * (g0 - 2.0f * g1 + g2);
        const float zw = Z.w[cz], zd = Z.dw[cz], zu = Z.u[cz];
        e_dw += xd * zw;
        e_ww += xw * zw;
        e_wd += xw * zd;
        e_Dw += xD * zw;
        e_du += xd * zu;
        e_uw += xu * zw;
        e_wu += xw * zu;
        e_ud += xu * zd;
        e_wD += xw * Z.du[cz];
        e_aw += xa * zw;
        e_dd += xd * zd;
        e_wa += xw * ddw[cz];
      }
      const float yw = Y.w[b], yd = Y.dw[b], yu = Y.u[b];
      dww += yw * e_dw;
      duw += yu * e_dw;
      ddw_ += yd * e_dw;
      wdw += yd * e_ww;
      wDw += Y.du[b] * e_ww;
      waw += ddw[b] * e_ww;
      wwd += yw * e_wd;
      wud += yu * e_wd;
      wdd += yd * e_wd;
      Dww += yw * e_Dw;
      dwu += yw * e_du;
      udw += yd * e_uw;
      wdu += yd * e_wu;
      uwd += yw * e_ud;
      wwD += yw * e_wD;
      aww += yw * e_aw;
      dwd += yw * e_dd;
      wwa += yw * e_wa;
    }
    const float r[21] = {dww, wdw, wwd,                          // d_a W
                         Dww, duw, dwu, udw, wDw, wdu, uwd, wud, wwD,
                         aww, ddw_, dwd, ddw_, waw, wdd, dwd, wdd, wwa};
    float* o = out + (size_t)(21 * cc) * NP + p;
#pragma unroll
    for (int i = 0; i < 21; ++i) __stcs(o + (size_t)i * NP, r[i]);
  }
  __stcs(out + (size_t)(21 * NCOMP) * NP + p, 0.0f);  // row 63
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS_PER_SM)
sored_kernel(const float* __restrict__ q, const float* __restrict__ planes,
             const int* __restrict__ chunk_tile,
             const int* __restrict__ chunk_live, float* __restrict__ out,
             int NP, int nchunk, int nt, int S, int g, float inv_dx) {
  extern __shared__ __align__(128) float bufs[];  // two tile buffers
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // this CTA's chunks, c = blockIdx.x + k * gridDim.x, taken from the last
  // (the dead tail) to the first
  const int cta = blockIdx.x, n = gridDim.x;
  const int K = cta < nchunk ? (nchunk - 1 - cta) / n + 1 : 0;
  auto chunk_at = [&](int j) { return cta + (K - 1 - j) * n; };
  auto next_live = [&](int j) {
    while (j < K && chunk_live[chunk_at(j)] != 1) ++j;
    return j;
  };

  // The same in every thread: the tile in buffer `use`, the tile staged or
  // landing in buffer use ^ 1, and per buffer (bit b) the parity its
  // barrier waits for next and whether a copy into it is in flight.
  int cur = -1, nxt = -1, use = 1;
  uint32_t phase = 0u, pending = 0u;
  auto fetch = [&](int buf, int t) {
    if (tid == 0)
      stage_tile(bufs + buf * TILE_FLOATS, &bar[buf],
                 planes + (size_t)t * TILE_FLOATS);
    pending |= 1u << buf;
  };
  auto land = [&](int buf) {
    if ((pending >> buf) & 1u) {
      wait_tile(&bar[buf], (phase >> buf) & 1u);
      phase ^= 1u << buf;
      pending &= ~(1u << buf);
    }
  };

  int k = next_live(0);
  if (k < K) {
    nxt = chunk_tile[chunk_at(k)];
    fetch(0, nxt);
  }
  for (int j = 0; j < K; ++j) {
    const int c = chunk_at(j);
    if (chunk_live[c] != 1) {
      zero_chunk(out, c, NP, S);
      continue;
    }
    const int t = chunk_tile[c];
    if (t != cur) {  // switch to the other buffer
      const int o = use ^ 1;
      if (nxt != t) {  // not prefetched: tables that revisit a tile
        land(o);
        __syncthreads();  // nobody reads buffer o any more
        fetch(o, t);
      }
      land(o);
      use = o;
      cur = t;
      nxt = -1;
    }
    // prefetch the next live chunk's tile into the other buffer
    const int kn = next_live(j + 1);
    if (kn < K) {
      const int tn = chunk_tile[chunk_at(kn)];
      if (tn != t && tn != nxt) {
        const int o = use ^ 1;
        land(o);
        __syncthreads();  // the chunks that read buffer o are done
        fetch(o, tn);
        nxt = tn;
      }
    }
    const int torg[3] = {(t / (nt * nt)) * T_TILE, ((t / nt) % nt) * T_TILE,
                         (t % nt) * T_TILE};
    const float* win = bufs + use * TILE_FLOATS;
    for (int s = tid; s < S; s += THREADS)
      reduce_slot(win, q, out, (size_t)c * S + s, NP, torg, g, inv_dx);
  }
  land(0);
  land(1);
}

// Launch geometry of one device, computed at its first launch.
struct Geometry {
  int sms = 0, ctas_per_sm = 0;
};
constexpr int MAX_DEVICES = 64;
Geometry geometry[MAX_DEVICES];

cudaError_t device_geometry(Geometry* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Geometry& geo = geometry[dev];
  if (geo.sms == 0) {
    err = cudaFuncSetAttribute(
        sored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sored_kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    geo.ctas_per_sm = per_sm;
    geo.sms = sms;
  }
  *out = geo;
  return cudaSuccess;
}

int grid_ctas(const Geometry& geo, int nchunk) {
  const int full = geo.sms * geo.ctas_per_sm;
  return nchunk < full ? (nchunk > 0 ? nchunk : 1) : full;
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
  Geometry geo;
  cudaError_t err = device_geometry(&geo);
  if (err != cudaSuccess) return err;
  sored_kernel<<<grid_ctas(geo, nchunk), THREADS, SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      q, planes, chunk_tile, chunk_live, out, NP, nchunk, nt, S, g, inv_dx);
  return cudaGetLastError();
}

// info: CTAs a launch over nchunk chunks takes, threads per CTA, dynamic
// shared memory per CTA (bytes), registers per thread, local memory per
// thread (bytes, spills), CTAs per SM, SMs.
int gsmpm_sored_info(int nchunk, int* info) {
  Geometry geo;
  cudaError_t err = device_geometry(&geo);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, sored_kernel);
  if (err != cudaSuccess) return err;
  info[0] = grid_ctas(geo, nchunk);
  info[1] = THREADS;
  info[2] = SMEM_BYTES;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  info[5] = geo.ctas_per_sm;
  info[6] = geo.sms;
  return cudaSuccess;
}

}  // extern "C"
