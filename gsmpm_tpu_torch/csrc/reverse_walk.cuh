// The reverse blend walk shared by K5 / K9 (csrc/tile_blend.cu) and K7
// (csrc/stream_raster.cu), for Hopper (sm_90a), fp32.
//
// A walk takes one pixel block (K5 / K9: a candidate window; K7: a display
// block's segment of the sorted stream) back to front from its largest last
// contributor, recovering each pixel's transmittance by division and
// keeping the suffix S of w (c . g_rgb), and sums per slot 9 quantities
// over the block's pixels.  What is shared here:
//
// - The grid.  The block's 16 x 8 pixel groups go one to a warp (lane l
//   owns column l % 16 of rows l / 16, + 2, + 4, + 6 of its group, as in
//   K3), NW = 8 warps to a CUDA block, and the ceil(groups / 8) CUDA blocks
//   of one pixel block form a thread block cluster: the fit's 40 tier-2
//   windows fill 160 CUDA blocks at B = 64, not 40.  The blocks of a
//   cluster walk the same steps of CH = 256 slots in lockstep.
// - The cull.  Each staged slot carries a box (the kernel's own: the
//   gate's ellipse, widened against rounding) outside which it cannot pass
//   the gate.  A warp lists, by ballot, the staged slots before its own
//   largest last contributor whose box meets its group, and walks that
//   list back to front; each lane skips a slot whose box misses its pixel
//   before the power and the exp.  A culled pair is one the gate rejects,
//   so every pixel meets the contributors of the unculled walk in the same
//   order with the same expressions: T and S are those of the unculled
//   walk, bit for bit.
// - The sums, in a fixed order, so the result is deterministic.  A warp
//   that reached a slot (some lane passed the gate) sums its lanes by a
//   fixed butterfly of shuffles and stores the 9 sums as its partial, with
//   a bit in its mask; no zero partial is stored.  The block then sums the
//   partials of its warps in warp order (reading only the marked ones),
//   and after a cluster barrier each block totals a slice of the step's
//   slots over the cluster's blocks in rank order through distributed
//   shared memory.  The block sums are double-buffered by step parity, so
//   that one barrier per step keeps them until every block has read them.
//   No global scratch and no atomics: the same window gives the same bits
//   in every run, in K5 and in K9.
//
// Measured on the H100 at the fit (chip_smoke.py): one 32-warp block per
// 64-pixel block (the cull alone) was 8-10% slower than the cluster of
// four 8-warp blocks; 256 slots per step beat 128 (the deepest window
// walks 23,199 candidates, so per-step barriers add up); groups of 16 x 4
// and 16 x 2 pixels per warp, and pixels evaluated without branches, were
// slower.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rwalk {

namespace cg = cooperative_groups;

constexpr int NW = 8;                  // warps (pixel groups) per CUDA block
constexpr int CH = 256;                // slots staged per step
constexpr int PPT = 4;                 // pixels per lane: 16 x 8 per warp
constexpr int NSUM = 9;                // sums per slot
constexpr int WORDS = CH / 32;         // mask words per step
constexpr unsigned FULL = 0xffffffffu;

// A block's shared memory, for NS staged rows per slot (about 111 KB for
// K7's 19, so two blocks fit an SM).  The block's sums are double-buffered
// by step parity, so one cluster barrier per step keeps them until every
// block has read them.
template <int NS>
struct Shared {
  float st[NS][CH];                    // the kernel's staged rows
  float part[NW][NSUM][CH];            // each warp's sums of its slots
  float bpart[2][NSUM][CH];            // the block's sums, warps in order
  unsigned wmask[NW][WORDS];           // the slots each warp stored
  unsigned bmask[2][WORDS];            // the slots any warp stored
  unsigned char list[NW][CH];          // each warp's culled slot list
  int top;                             // the block's largest last contributor
};

// A block's 16 x 8 pixel groups
__host__ __device__ __forceinline__ int groups_of(int B) {
  return (B / 16) * (B / 8);
}

// CUDA blocks (the cluster size) per pixel block: 4 at B = 64
__host__ __device__ __forceinline__ int blocks_per(int B) {
  return (groups_of(B) + NW - 1) / NW;
}

// CUDA blocks of one launch over nb pixel blocks of edge B
__host__ __device__ __forceinline__ int grid_of(int nb, int B) {
  return nb * blocks_per(B);
}

// A lane's 4 pixels of its warp's group and their reverse-walk state.
struct Lane {
  float px, pxx;
  float py[PPT], T[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT];
  int last[PPT];
  int top;                             // the warp's largest last contributor
  float rx0, ry0;                      // the group's origin
};

// Lane state of group `rect` from the blend state ob and its cotangent gb
// (8, B*B) of the pixel block: T, S seeded with T_final g_T, g_rgb, and
// the last contributor + 1.  A warp past the block's groups gets none.
__device__ __forceinline__ void load_lane(Lane& ln, int rect, int B,
                                          const float* ob, const float* gb,
                                          int lane) {
  const int P = B * B;
  const int rects_x = B / 16;
  const bool live = rect < groups_of(B);
  const int rx0 = (rect % rects_x) * 16, ry0 = (rect / rects_x) * 8;
  ln.rx0 = (float)rx0;
  ln.ry0 = (float)ry0;
  ln.px = (float)(rx0 + (lane & 15));
  ln.pxx = ln.px * ln.px;
  int top = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int yi = ry0 + (lane >> 4) + 2 * k;
    const int p = yi * B + rx0 + (lane & 15);
    ln.py[k] = (float)yi;
    ln.T[k] = live ? ob[3 * P + p] : 1.0f;
    ln.S[k] = live ? ln.T[k] * gb[3 * P + p] : 0.0f;
    ln.gr[k] = live ? gb[0 * P + p] : 0.0f;
    ln.gg[k] = live ? gb[1 * P + p] : 0.0f;
    ln.gb[k] = live ? gb[2 * P + p] : 0.0f;
    ln.last[k] = live ? (int)ob[5 * P + p] : 0;
    top = max(top, ln.last[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = max(top, __shfl_xor_sync(FULL, top, off));
  ln.top = top;
}

// The largest last contributor over the cluster's warps.  Ends with a
// cluster barrier: a block whose walk is empty may then exit.
template <class Sh>
__device__ __forceinline__ int cluster_top(cg::cluster_group& cl, Sh& sh,
                                           const Lane& ln, int lane) {
  if (threadIdx.x == 0) sh.top = 0;
  __syncthreads();
  if (lane == 0 && ln.top > 0) atomicMax(&sh.top, ln.top);
  cl.sync();
  int top = 0;
  for (unsigned s = 0; s < cl.num_blocks(); ++s)
    top = max(top, cl.map_shared_rank(&sh, s)->top);
  cl.sync();
  return top;
}

// The log alpha of a (slot, pixel) pair, summed in the twins' order
__device__ __forceinline__ float power_of(float F0, float F1, float F2,
                                          float F3, float F4, float F5,
                                          float F6, float pxx, float px,
                                          float pyy, float py, float pxy) {
  float power = F0 * pxx;
  power = power + F1 * px;
  power = power + F2;
  power = power + F3 * pyy;
  power = power + F4 * py;
  power = power + F5 * pxy;
  return power + F6;
}

// A staged slot as a lane's walk reads it
struct Slot {
  float F[7];                          // F0..F5 and the log opacity
  float c[3];                          // colors
  float gx, gy;                        // the splat's centre (K7's sums)
  float yl, yh;                        // the box's rows
};

// The lane's pixels of one slot, back to front: each pixel at or before
// its last contributor and inside the box's rows takes the forward's gate
// (power <= log opacity, alpha >= alpha_min); where it passes, T becomes
// T_before (by division), S takes w (c . g_rgb), and the 9 sums v take
// dpower times the pixel's monomials (CENTRED: those of its offset from
// the splat's centre, dx^2, dx dy, dy^2, dx, dy, 1; else the block-local
// px^2, px, 1, py^2, py, px py) and g_rgb w.  dpower is 0 where
// exp(power) reaches the 0.99 clamp.  Returns whether any pixel passed.
template <bool CENTRED>
__device__ __forceinline__ bool walk_slot(Lane& ln, int idx1,
                                          const Slot& s, float alpha_min,
                                          float (&v)[NSUM]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float py = ln.py[k];
    if (idx1 > ln.last[k] || py < s.yl || py > s.yh) continue;
    const float pyy = py * py, pxy = ln.px * py;
    const float power = power_of(s.F[0], s.F[1], s.F[2], s.F[3], s.F[4],
                                 s.F[5], s.F[6], ln.pxx, ln.px, pyy, py,
                                 pxy);
    const float expp = expf(power);
    const float alpha = fminf(0.99f, expp);
    if (!(power <= s.F[6] && alpha >= alpha_min)) continue;
    const float one_minus = 1.0f - alpha;
    const float T_before = ln.T[k] / one_minus;
    const float w = T_before * alpha;
    const float cdot = s.c[0] * ln.gr[k] + s.c[1] * ln.gg[k]
                       + s.c[2] * ln.gb[k];
    const float dA = T_before * cdot - ln.S[k] / one_minus;
    const float dP = expp < 0.99f ? dA * alpha : 0.0f;
    ln.S[k] += w * cdot;
    ln.T[k] = T_before;
    if (CENTRED) {
      const float dx = ln.px - s.gx, dy = py - s.gy;
      v[0] += dx * dx * dP;
      v[1] += dx * dy * dP;
      v[2] += dy * dy * dP;
      v[3] += dx * dP;
      v[4] += dy * dP;
      v[5] += dP;
    } else {
      v[0] += ln.pxx * dP;
      v[1] += ln.px * dP;
      v[2] += dP;
      v[3] += pyy * dP;
      v[4] += py * dP;
      v[5] += pxy * dP;
    }
    v[6] += ln.gr[k] * w;
    v[7] += ln.gg[k] * w;
    v[8] += ln.gb[k] * w;
    any = true;
  }
  return any;
}

// The warp's list, in slot order, of the staged slots j < jmax whose box
// (x lo, x hi, y lo, y hi) meets its 16 x 8 group at (rx0, ry0); returns
// its length.  The forward walks K3 (csrc/stream_raster.cu) and K4 / K8
// (csrc/tile_blend.cu) list their slots the same way.
__device__ __forceinline__ int warp_list(const float* xl, const float* xh,
                                         const float* yl, const float* yh,
                                         int jmax, float rx0, float ry0,
                                         unsigned char* list, int lane) {
  const float rxhi = rx0 + 15.0f, ryhi = ry0 + 7.0f;
  int count = 0;
  for (int j0 = 0; j0 < jmax; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < jmax && xl[j] <= rxhi && xh[j] >= rx0
                     && yl[j] <= ryhi && yh[j] >= ry0;
    const unsigned m = __ballot_sync(FULL, hit);
    if (hit) list[count + __popc(m & ((1u << lane) - 1u))] = (unsigned char)j;
    count += __popc(m);
  }
  __syncwarp();
  return count;
}

// Clear the warp's mask before a step's walk.
template <class Sh>
__device__ __forceinline__ void clear_mask(Sh& sh, int warp, int lane) {
  if (lane < WORDS) sh.wmask[warp][lane] = 0u;
}

// The warp's sums v of slot j over its lanes, stored as its partial when
// some lane reached the slot.
template <class Sh>
__device__ __forceinline__ void warp_emit(Sh& sh, int warp, int lane, int j,
                                          const float (&v)[NSUM], bool any) {
  if (!__any_sync(FULL, any)) return;
#pragma unroll
  for (int r = 0; r < NSUM; ++r) {
    float x = v[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    if (lane == 0) sh.part[warp][r][j] = x;
  }
  if (lane == 0) sh.wmask[warp][j >> 5] |= 1u << (j & 31);
}

// After the walk and a __syncthreads: the block's sums of the n staged
// slots into buffer q, its warps' stored partials added in warp order
// (zero where no warp stored one).
template <class Sh>
__device__ __forceinline__ void block_sum(Sh& sh, int n, int q) {
  for (int t = threadIdx.x; t < WORDS; t += blockDim.x) {
    unsigned m = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) m |= sh.wmask[w][t];
    sh.bmask[q][t] = m;
  }
  for (int i = threadIdx.x; i < NSUM * CH; i += blockDim.x) {
    const int r = i / CH, j = i % CH;
    if (j >= n) continue;
    const unsigned bit = 1u << (j & 31);
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (sh.wmask[w][j >> 5] & bit) x += sh.part[w][r][j];
    sh.bpart[q][r][j] = x;
  }
}

// This block's slice [j0, j1) of the n staged slots, for the cluster's
// totals after block_sum and a cluster barrier.
__device__ __forceinline__ void slice_of(cg::cluster_group& cl, int n,
                                         int& j0, int& j1) {
  const int per = (n + (int)cl.num_blocks() - 1) / (int)cl.num_blocks();
  j0 = min(n, (int)cl.block_rank() * per);
  j1 = min(n, j0 + per);
}

// The total of slot j over the cluster's blocks' sums in buffer q, in rank
// order; false when no warp of the cluster reached it (tot is then 0).
template <class Sh>
__device__ __forceinline__ bool cluster_total(cg::cluster_group& cl, Sh& sh,
                                              int j, int q,
                                              float (&tot)[NSUM]) {
#pragma unroll
  for (int r = 0; r < NSUM; ++r) tot[r] = 0.0f;
  unsigned any = 0u;
  for (unsigned s = 0; s < cl.num_blocks(); ++s) {
    const Sh* o = cl.map_shared_rank(&sh, s);
    any |= o->bmask[q][j >> 5];
#pragma unroll
    for (int r = 0; r < NSUM; ++r) tot[r] += o->bpart[q][r][j];
  }
  return (any >> (j & 31)) & 1u;
}

// Launch `kernel` on nb pixel blocks of edge B, each a cluster of
// blocks_per(B) CUDA blocks of NW warps with the dynamic shared memory of
// Sh.
template <class Sh, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int nb, int B,
                   cudaStream_t stream, Args... args) {
  const size_t smem = sizeof(Sh);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int S = blocks_per(B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_of(nb, B));
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace rwalk
