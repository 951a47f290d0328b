// Kernels K9 of phylo_tpu_torch: the wide bodies of the rank update and
// its two backwards, for messages of 8 < A states per block and G blocks,
// G * A <= 128 planes: dense (G = 1; codon GY94: A = 61) and blocked
// (G > 1, a rate mixture over a wide base; protein + Gamma4: G = 4,
// A = 20, 80 planes).
//
// K9f replaces phylo_tpu/pruning/kernels.py::fused_rank_update's wide
// body (_kernel_rank_wide, selected when G*A*A > 64), K9bs
// ::fused_rank_bwd_saved's (_kernel_rank_bwd_saved_wide ->
// _rank_bwd_core_wide) and K9b ::fused_rank_bwd's (_kernel_rank_bwd_wide
// -> _rank_bwd_core_wide, children re-gathered by idx).  The math is
// that of the narrow kernels in rank_kernels.cu (K1, K2, K3): per
// particle k and site s, u = P_l^T m1, v = P_r^T m2, w = u * v, scale =
// max(max_a w, tiny), rootll / logscale site sums, the column write, and
// in reverse the cotangents with reduce-max's split among ties and the
// max(raw, tiny) half-split.  Layouts are the same: states-major
// (G*A, S) messages, (K, R, G*A, S) buffer, idx (4, K) = [row1, node1,
// row2, node2], (K, G, A, A) row-major transitions ((K, A, A) for G = 1).
// Blocked, plane g*A + b contracts against its own block only (JAX's
// `_dot_planes`, one dot per block): u[g*A + b] = sum_a m1[g*A + a]
// P_l[k, g, a, b]; the rescale max and the pi-weighted root sum still run
// over all G*A planes of a site, as in the dense case.
//
// What bounds them on an H100.  Per particle and site the forward does
// 2 G A^2 FMAs (A = 61: 7,442; G = 4, A = 20: 3,200) against 3 G A
// floats of traffic, A / 3 FLOP per byte; the backwards do 6 G A^2 FMAs
// against about 5 G A floats, 0.6 A FLOP per byte.  The card's FP32
// ridge is 20 FLOP/B (67 TFLOP/s over 3.35 TB/s): codons (A = 61) sit
// at it or above (operations), protein (A = 20) below it, where the
// bytes bound (chip_smoke.py computes the bound of each launch).  The TPU ran the contractions on its MXU in a multi-pass
// exact-f32 emulation; here they are FP32 FMAs on the CUDA cores (no
// tensor cores: no TF32, no wgmma), in a fixed order.
//
// Design of K9f.  A tile is 32 sites (one warp's width) x all G*A
// planes, staged in shared memory with a pitch of 33 floats, so a warp
// reading one plane's 32 sites and a warp reading 32 planes' same site
// are both free of bank conflicts.  P_l, P_r (2 G A^2 floats) and pi sit
// in shared memory, and the contractions loop over the G blocks, each the
// dense contraction on its own A planes; dynamic shared memory above 48
// KB is opted into per kernel.  Every u[b, s] and v[b, s] is the same FMA
// chain (a ascending from 0, one rounding per step, `contract_pair`) in
// the forward and the backward, so the backward's tie test w == max sees
// the forward's bits.  One block per (particle, site tile), 256 threads;
// a warp owns a set of planes, a lane a site.  Warp 0 then reduces each
// site over all G*A planes (max, pi-sum) in plane order, writes w / scale
// into buffer column outc IN PLACE (the column written is never among the
// columns read) and one partial rootll / logscale per tile, which the
// wrapper sums with torch.sum (fixed order, no atomics).
//
// Design of the backward (K9bs, K9b, K11a above 8 states).  The former
// form ran one block per particle over the site tiles in turn (128 blocks at
// GY94, 32 at K11a), the per-site scalars on warp 0 alone, and every FMA
// of its three contractions with a shared-memory operand (the card's
// shared memory serves 32 floats a clock an SM against 128 FMA lanes):
// 13.5x its bound at GY94.  Now the grid is (cluster of up to 8 blocks,
// particle): the blocks of a particle split its chunks of 32 sites, and
// each thread computes a (4 x 4) register tile of each contraction from
// float4 operands, 8 FMAs a shared-memory load; the per-site scalars are
// reduced over the plane tiles by every warp (xor shuffles) and over the
// warps in order; dP sums over a block's chunks in registers and over
// the cluster's blocks in rank order through distributed shared memory,
// written once (wide_rank_bwd_kernel says each step).  The site and
// gm-sums are now per 4-plane tile, then tiles, then warps: a different
// association from K9f's single chain over the planes (phase 2 holds the
// backward to 1e-4 relative); u, v, and so the tie test, are K9f's
// chains.  dpi and dw come back as per-particle partial rows.
// Every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <type_traits>

namespace {

constexpr int kTile = 32;          // sites per tile: one warp's lanes
constexpr int kPitch = kTile + 1;  // shared-memory row pitch
constexpr int kFwdThreads = 256;
constexpr int kMaxPlanes = 128;   // G * A
constexpr int kMaxCluster = 8;     // backward: blocks a particle (portable)

// Backward threads a block at most, for NST site tiles of 4 a chunk.
__host__ __device__ constexpr int bwd_max_threads(int nst) {
  return nst > 8 ? 32 * nst : 256;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Asynchronous 4-byte copies from global to shared memory (sm_80+): a
// thread issues many and then waits for all of its copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ const float* child_slab(
    const float* leaves, const float* buf, int row, int node, int N, int R,
    size_t slab) {
  return node < N ? leaves + (size_t)node * slab
                  : buf + ((size_t)row * R + (node - N)) * slab;
}

// Stage the (P, kTile) tile of message m (P planes, S sites) at site s0
// in x (pitch kPitch), zeros past S; with `save`, copy what was read
// there too.
__device__ __forceinline__ void load_tile(const float* m, float* x, int P,
                                          int S, int s0, float* save) {
  for (int e = threadIdx.x; e < P * kTile; e += blockDim.x) {
    const int a = e / kTile, s = e - a * kTile, gs = s0 + s;
    float val = 0.f;
    if (gs < S) {
      val = m[(size_t)a * S + gs];
      if (save) save[(size_t)a * S + gs] = val;
    }
    x[a * kPitch + s] = val;
  }
}

// u[j] = sum_a x1[a, s] pl[a, b_j], v[j] likewise with x2, pr, for the
// NB planes b_j = b0 + j * bstride (clamped to A - 1: the caller drops
// b_j >= A).  One FMA chain per plane, a ascending from 0.
template <int NB>
__device__ __forceinline__ void contract_pair(
    const float* x1, const float* x2, const float* pl, const float* pr,
    int A, int b0, int bstride, int s, float (&u)[NB], float (&v)[NB]) {
  int bj[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    bj[j] = min(b0 + j * bstride, A - 1);
    u[j] = 0.f;
    v[j] = 0.f;
  }
  for (int a = 0; a < A; ++a) {
    const float y1 = x1[a * kPitch + s], y2 = x2[a * kPitch + s];
    const float* pla = pl + a * A;
    const float* pra = pr + a * A;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      u[j] = __fmaf_rn(y1, pla[bj[j]], u[j]);
      v[j] = __fmaf_rn(y2, pra[bj[j]], v[j]);
    }
  }
}

// One block's A planes: the warp `bw` of `nw` owns planes b = b0 + j * nw,
// NB at a time.  Fwd stores w = u * v in o1, else u in o1 and v in o2.
template <int NB, bool Fwd>
__device__ __forceinline__ void contract_block(
    const float* x1, const float* x2, const float* pl, const float* pr,
    int A, int bw, int nw, int s, float* o1, float* o2) {
  for (int b0 = bw; b0 < A; b0 += NB * nw) {
    float u[NB], v[NB];
    contract_pair<NB>(x1, x2, pl, pr, A, b0, nw, s, u, v);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = b0 + j * nw;
      if (b < A) {
        if (Fwd) {
          o1[b * kPitch + s] = __fmul_rn(u[j], v[j]);
        } else {
          o1[b * kPitch + s] = u[j];
          o2[b * kPitch + s] = v[j];
        }
      }
    }
  }
}

// Calls f(std::integral_constant<int, NB>{}) with NB = min(nb, 4) >= 1:
// the compile-time count of planes a warp computes at a time.
template <typename F>
__device__ __forceinline__ void with_nb(int nb, F&& f) {
  if (nb >= 4)
    f(std::integral_constant<int, 4>{});
  else if (nb == 3)
    f(std::integral_constant<int, 3>{});
  else if (nb == 2)
    f(std::integral_constant<int, 2>{});
  else
    f(std::integral_constant<int, 1>{});
}

// u, v of all G blocks (x tiles, P blocks and outputs at the block's
// offsets).  NB = ceil(A / nw) up to 4, so a warp computes no more chains
// than its planes need (A = 20 on 8 warps: 3, on 16: 2).
template <bool Fwd>
__device__ __forceinline__ void contract_blocks(
    const float* x1, const float* x2, const float* pl, const float* pr,
    int G, int A, int bw, int nw, int s, float* o1, float* o2) {
  with_nb((A + nw - 1) / nw, [&](auto nb) {
    for (int g = 0; g < G; ++g) {
      const int off = g * A * kPitch, poff = g * A * A;
      contract_block<decltype(nb)::value, Fwd>(
          x1 + off, x2 + off, pl + poff, pr + poff, A, bw, nw, s, o1 + off,
          Fwd ? nullptr : o2 + off);
    }
  });
}

// Particle k's transitions (GAA = G A^2 floats a side) and pi (GA) into
// shared memory.
__device__ __forceinline__ void load_params(float* pl, float* pr, float* pv,
                                            const float* Pl, const float* Pr,
                                            const float* pi, int k, int GAA,
                                            int GA) {
  for (int c = threadIdx.x; c < GAA; c += blockDim.x) {
    pl[c] = Pl[(size_t)k * GAA + c];
    pr[c] = Pr[(size_t)k * GAA + c];
  }
  for (int c = threadIdx.x; c < GA; c += blockDim.x) pv[c] = pi[c];
}

// K9f.  grid (K, T), T = ceil(S / kTile); partial rows (K, T).
__global__ void __launch_bounds__(kFwdThreads) wide_rank_kernel(
    const float* __restrict__ leaves, float* buf,
    const int* __restrict__ idx, const float* __restrict__ Pl,
    const float* __restrict__ Pr, const float* __restrict__ pi,
    const float* __restrict__ w, float* __restrict__ rootll_part,
    float* __restrict__ logscale_part, float* __restrict__ c1,
    float* __restrict__ c2, int K, int R, int N, int G, int A, int S,
    int outc) {
  extern __shared__ float smem[];
  const int GA = G * A, AA = A * A, GAA = G * AA;
  float* pl = smem;
  float* pr = pl + GAA;
  float* pv = pr + GAA;
  float* x1 = pv + GA;
  float* x2 = x1 + GA * kPitch;
  float* wt = x2 + GA * kPitch;
  float* sc = wt + GA * kPitch;         // kTile per-site scales
  const int k = blockIdx.x, tile = blockIdx.y, T = gridDim.y;
  const int s0 = tile * kTile;
  const size_t slab = (size_t)GA * S;
  load_params(pl, pr, pv, Pl, Pr, pi, k, GAA, GA);
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  load_tile(m1, x1, GA, S, s0, c1 ? c1 + (size_t)k * slab : nullptr);
  load_tile(m2, x2, GA, S, s0, c2 ? c2 + (size_t)k * slab : nullptr);
  __syncthreads();

  const int s = threadIdx.x & 31, bw = threadIdx.x >> 5;
  contract_blocks<true>(x1, x2, pl, pr, G, A, bw, blockDim.x >> 5, s, wt,
                        nullptr);
  __syncthreads();

  if (threadIdx.x < kTile) {            // warp 0: one lane per site
    float raw = __int_as_float(0xff800000), site = 0.f;  // -inf
    for (int b = 0; b < GA; ++b) {      // max and root sum: all planes
      const float x = wt[b * kPitch + s];
      raw = fmaxf(raw, x);
      site = __fmaf_rn(x, pv[b], site);
    }
    const float scale = fmaxf(raw, FLT_MIN);
    sc[s] = scale;
    float acc0 = 0.f, acc1 = 0.f;
    if (s0 + s < S) {
      const float ws = w[s0 + s];
      acc0 = logf(site) * ws;
      acc1 = logf(scale) * ws;
    }
    acc0 = warp_sum(acc0);
    acc1 = warp_sum(acc1);
    if (s == 0) {
      rootll_part[(size_t)k * T + tile] = acc0;
      logscale_part[(size_t)k * T + tile] = acc1;
    }
  }
  __syncthreads();

  float* out = buf + ((size_t)k * R + outc) * slab;
  for (int e = threadIdx.x; e < GA * kTile; e += blockDim.x) {
    const int a = e / kTile, ss = e - a * kTile, gs = s0 + ss;
    if (gs < S) out[(size_t)a * S + gs] = wt[a * kPitch + ss] / sc[ss];
  }
}

// Four floats of shared memory at a 16-byte-aligned address.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared-memory layout of the backward (floats; every region 16-byte
// aligned): P_l, P_r as (G, AP, AP) zero-padded blocks, reused at the end
// as the dP / dpi staging row; pi; the chunk's x1, x2, gm (then du) and dv
// tiles, (G*AP, SC) at pitch SC + 4; the warps' per-site partials (4 x
// warps x SC); the per-site scalars (5 x SC); the dpi partials (NST x
// G*AP).
struct BwdLayout {
  int AP, GAP, tile, preg, pv, x1, dv, wpart, ssc, dpis, total;
  __host__ __device__ BwdLayout(int G, int A, int NST) {
    const int SC = 4 * NST, SCP = SC + 4, GA = G * A;
    AP = (A + 3) & ~3;
    GAP = G * AP;
    tile = GAP * SCP;
    const int stage = (2 * G * A * A + GA + 3) & ~3;
    preg = 2 * G * AP * AP > stage ? 2 * G * AP * AP : stage;
    pv = preg;
    x1 = pv + ((GA + 3) & ~3);          // then x2, gm a tile apart
    dv = x1 + 3 * tile;
    wpart = dv + tile;
    ssc = wpart + 4 * (bwd_max_threads(NST) / 32) * SC;
    dpis = ssc + 5 * SC;
    total = dpis + NST * GAP;
  }
};

// K9bs (Gather = false, saved children m1g / m2g) and K9b (Gather = true,
// children re-gathered from leaves / buf by idx); K11a above 8 states.
// grid (C, K), a cluster of the C blocks of particle k = blockIdx.y;
// block r takes the chunks c = r, r + C, ... of SC = 4 NST sites.  Its
// threads are (plane tile pt, site tile st) pairs, tid = pt NST + st, for
// the G * ceil(A / 4) tiles of 4 planes (A padded to AP = 4 ceil(A / 4)
// per block) and the NST tiles of 4 sites.  Per chunk, five barriers:
//  (1) x1, x2, gm of the chunk into shared memory;
//  (2) u, v of the thread's 4 x 4 tile in registers (a ascending from 0,
//      one FMA chain each, K9f's chains: a float4 of P_l[a, b0..b0+3] and
//      one of x1[a, s0..s0+3] feed 16 FMAs a side), w = u v, and the
//      tile's partial (max, ties, pi-sum, gm-sum) of its 4 sites over its
//      real planes, combined over the warp's plane tiles by xor shuffles
//      and written per warp;
//  (3) one thread a site combines the warps' partials in warp order and
//      writes 1/scale, dsite, dscale's max share, 1 / the tie count, the
//      max (and the site's dw);
//  (4) du = dwp v over gm and dv = dwp u, from the registers of (2);
//  (5) dm = P du as (4 planes x 4 sites) tiles (float4s of four P rows
//      and four du rows: 64 FMAs a side per 8 loads), written to global
//      memory, and dP += x du^T as (4 x 4) tiles of (a, b) over the chunk's
//      sites (DPT tiles a thread, in registers across the block's chunks).
// After the last chunk the block stages dP and dpi (summed over its site
// tiles in order) in shared memory; rank r of the cluster sums its slice
// of every rank's row in rank order through distributed shared memory and
// writes it once.  Deterministic: no float atomics, every sum in a fixed
// order.
template <bool Gather, int DPT, int NST>
__global__ void __launch_bounds__(bwd_max_threads(NST)) wide_rank_bwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ leaves, const float* __restrict__ buf,
    const int* __restrict__ idx, const float* __restrict__ gmg,
    const float* __restrict__ gr, const float* __restrict__ gl,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ dm1g, float* __restrict__ dm2g,
    float* __restrict__ dPl, float* __restrict__ dPr,
    float* __restrict__ dpi_part, float* __restrict__ dw_part, int K, int R,
    int N, int G, int A, int S) {
  constexpr int SC = 4 * NST, SCP = SC + 4;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L(G, A, NST);
  const int AP = L.AP, GAP = L.GAP, NPT = AP / 4, GT = G * NPT;
  const int GA = G * A, AA = A * A, GAA = G * AA;
  const int C = gridDim.x, r = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, NT = blockDim.x, NW = NT >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  float* pl = smem;
  float* pr = smem + G * AP * AP;
  float* pv = smem + L.pv;
  float* dv = smem + L.dv;
  float* wpart = smem + L.wpart;
  float* ssc = smem + L.ssc;
  float* dpis = smem + L.dpis;
  const size_t slab = (size_t)GA * S;

  {                                     // P by cp.async, zero padding
    const int q = NT / AP, rem = NT - q * AP;
    int g = 0, a = tid / AP, b = tid - a * AP;
    while (a >= AP) {
      a -= AP;
      ++g;
    }
    const float* pls = Pl + (size_t)k * GAA;
    const float* prs = Pr + (size_t)k * GAA;
    for (int e = tid; e < G * AP * AP; e += NT) {  // e = (g AP + a) AP + b
      if (a < A && b < A) {
        cp_async4(pl + e, pls + g * AA + a * A + b);
        cp_async4(pr + e, prs + g * AA + a * A + b);
      } else {
        pl[e] = pr[e] = 0.f;
      }
      b += rem;
      a += q;
      if (b >= AP) {
        b -= AP;
        ++a;
      }
      while (a >= AP) {
        a -= AP;
        ++g;
      }
    }
  }
  for (int c = tid; c < GA; c += NT) pv[c] = pi[c];
  for (int e = tid; e < (AP - A) * G * SC; e += NT) {  // padded planes
    const int row = e / SC, s = e - row * SC;
    const int g = row / (AP - A), a = A + row % (AP - A);
    float* x = smem + L.x1 + (g * AP + a) * SCP + s;
    x[0] = 0.f;
    x[L.tile] = 0.f;
  }
  const float* m1 =
      Gather ? child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab)
             : m1g + (size_t)k * slab;
  const float* m2 =
      Gather ? child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R,
                          slab)
             : m2g + (size_t)k * slab;
  const float* gm = gmg + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;
  const float grk = gr[k], glk = gl[k];

  const int pt = tid / NST, st = tid - pt * NST;
  const bool tile = pt < GT;
  const int tg = tile ? pt / NPT : 0;   // the tile's block
  const int ta = (pt - tg * NPT) * 4;   // its first plane within the block
  const int prow = tg * AP + ta;        // its first padded row
  const int ntiles = 2 * G * NPT * NPT;
  float dpa[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[DPT][16];
#pragma unroll
  for (int j = 0; j < DPT; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;

  const int nch = (S + SC - 1) / SC;
  // chunk c's x1, x2, gm by cp.async, every copy in flight at once; zeros
  // past S
  auto issue = [&](int c) {
    float* x = smem + L.x1;
    const int s = tid % SC, gs = c * SC + s;
    int g = 0, a = tid / SC;
    for (int p = a; p < GA; p += NT / SC) {
      while (a >= A) {                  // p = g A + a without a division
        a -= A;
        ++g;
      }
      float* d = x + (g * AP + a) * SCP + s;
      if (gs < S) {
        const size_t src = (size_t)p * S + gs;
        cp_async4(d, m1 + src);
        cp_async4(d + L.tile, m2 + src);
        cp_async4(d + 2 * L.tile, gm + src);
      } else {
        d[0] = d[L.tile] = d[2 * L.tile] = 0.f;
      }
      a += NT / SC;
    }
  };
  for (int c = r; c < nch; c += C) {
    const int c0 = c * SC;
    // (1) this chunk's tiles (the first chunk's with P's copies)
    issue(c);
    cp_async_wait_all();
    __syncthreads();
    const float* x1 = smem + L.x1;
    const float* x2 = x1 + L.tile;
    float* gd = smem + L.x1 + 2 * L.tile;  // gm, then du

    // (2) u, v and the partial per-site scalars over the tile's planes
    float u[4][4], v[4][4];
    float praw[4], pneq[4], psite[4], pgsum[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      praw[s] = __int_as_float(0xff800000);  // -inf
      pneq[s] = psite[s] = pgsum[s] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
    }
    if (tile) {
      const float* pla = pl + tg * AP * AP + ta;
      const float* pra = pr + tg * AP * AP + ta;
      const float* y1 = x1 + tg * AP * SCP + st * 4;
      const float* y2 = x2 + tg * AP * SCP + st * 4;
#pragma unroll 4
      for (int a = 0; a < A; ++a) {
        const float4 p1 = ld4(pla + a * AP), p2 = ld4(pra + a * AP);
        const float4 z1 = ld4(y1 + a * SCP), z2 = ld4(y2 + a * SCP);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            u[i][s] = __fmaf_rn(comp(z1, s), comp(p1, i), u[i][s]);
            v[i][s] = __fmaf_rn(comp(z2, s), comp(p2, i), v[i][s]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ta + i < A) {
          const float piv = pv[tg * A + ta + i];
          const float4 g4 = ld4(gd + (prow + i) * SCP + st * 4);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float x = __fmul_rn(u[i][s], v[i][s]);
            psite[s] = __fmaf_rn(x, piv, psite[s]);
            pgsum[s] = __fmaf_rn(comp(g4, s), x, pgsum[s]);
            if (x > praw[s]) {
              praw[s] = x;
              pneq[s] = 1.f;
            } else if (x == praw[s]) {
              pneq[s] += 1.f;
            }
          }
        }
      }
    }
    // the warp's plane tiles of one site tile: lanes st + NST q
#pragma unroll
    for (int o = NST; o < 32; o <<= 1)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float rr = __shfl_xor_sync(0xffffffffu, praw[s], o);
        const float nn = __shfl_xor_sync(0xffffffffu, pneq[s], o);
        const float ss = __shfl_xor_sync(0xffffffffu, psite[s], o);
        const float gg = __shfl_xor_sync(0xffffffffu, pgsum[s], o);
        const float m = fmaxf(praw[s], rr);
        pneq[s] = (praw[s] == m ? pneq[s] : 0.f) + (rr == m ? nn : 0.f);
        praw[s] = m;
        psite[s] = psite[s] + ss;
        pgsum[s] = pgsum[s] + gg;
      }
    if (lane < NST) {
      st4(wpart + (0 * NW + warp) * SC + st * 4, praw[0], praw[1], praw[2],
          praw[3]);
      st4(wpart + (1 * NW + warp) * SC + st * 4, pneq[0], pneq[1], pneq[2],
          pneq[3]);
      st4(wpart + (2 * NW + warp) * SC + st * 4, psite[0], psite[1],
          psite[2], psite[3]);
      st4(wpart + (3 * NW + warp) * SC + st * 4, pgsum[0], pgsum[1],
          pgsum[2], pgsum[3]);
    }
    __syncthreads();

    // (3) one thread a site: the warps' partials in warp order
    if (tid < SC) {
      const int s = tid, gs = c0 + s;
      float raw = __int_as_float(0xff800000);
      for (int q = 0; q < NW; ++q) raw = fmaxf(raw, wpart[q * SC + s]);
      float neq = 0.f, site = 0.f, gsum = 0.f;
      for (int q = 0; q < NW; ++q) {
        if (wpart[q * SC + s] == raw) neq += wpart[(NW + q) * SC + s];
        site = site + wpart[(2 * NW + q) * SC + s];
        gsum = gsum + wpart[(3 * NW + q) * SC + s];
      }
      float inv = 0.f, dsite = 0.f, draw = 0.f;
      if (gs < S) {                      // padded sites carry no cotangent
        const float scale = fmaxf(raw, FLT_MIN);
        const float ws = w[gs];
        inv = 1.f / scale;
        dsite = (grk * ws) / site;
        const float dscale = (glk * ws) / scale - gsum * (inv * inv);
        // max(raw, tiny): full cotangent above the clamp, half at it
        draw = dscale *
               ((raw > FLT_MIN ? 1.f : 0.f) + (raw == FLT_MIN ? 0.5f : 0.f));
        dw_part[(size_t)k * S + gs] = grk * logf(site) + glk * logf(scale);
      }
      ssc[s] = inv;
      ssc[SC + s] = dsite;
      ssc[2 * SC + s] = draw;
      ssc[3 * SC + s] = 1.f / neq;       // eq / neq for eq in {0, 1}
      ssc[4 * SC + s] = raw;
    }
    __syncthreads();

    // (4) du over the cotangent tile, dv, and the dpi sums
    if (tile) {
      const float4 inv4 = ld4(ssc + st * 4), ds4 = ld4(ssc + SC + st * 4);
      const float4 dr4 = ld4(ssc + 2 * SC + st * 4);
      const float4 rq4 = ld4(ssc + 3 * SC + st * 4);
      const float4 rw4 = ld4(ssc + 4 * SC + st * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* gdi = gd + (prow + i) * SCP + st * 4;
        float* dvi = dv + (prow + i) * SCP + st * 4;
        if (ta + i < A) {
          const float piv = pv[tg * A + ta + i];
          const float4 g4 = ld4(gdi);
          float du_[4], dv_[4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float x = __fmul_rn(u[i][s], v[i][s]);
            // reduce-max cotangent split evenly among tied planes
            const float share = (x == comp(rw4, s)) ? comp(rq4, s) : 0.f;
            const float dwp = comp(g4, s) * comp(inv4, s) +
                              comp(ds4, s) * piv + comp(dr4, s) * share;
            du_[s] = dwp * v[i][s];
            dv_[s] = dwp * u[i][s];
            dpa[i] = __fmaf_rn(comp(ds4, s), x, dpa[i]);
          }
          st4(gdi, du_[0], du_[1], du_[2], du_[3]);
          st4(dvi, dv_[0], dv_[1], dv_[2], dv_[3]);
        } else {
          st4(gdi, 0.f, 0.f, 0.f, 0.f);
          st4(dvi, 0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    __syncthreads();

    // (5) dm1 = P_l du, dm2 = P_r dv (b ascending), to global memory
    if (tile) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const float* P = (side ? pr : pl) + tg * AP * AP + ta * AP;
        const float* y = (side ? dv : gd) + tg * AP * SCP + st * 4;
        float d[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int s = 0; s < 4; ++s) d[i][s] = 0.f;
#pragma unroll 2
        for (int b0 = 0; b0 < AP; b0 += 4) {
          float4 pp[4], yy[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pp[i] = ld4(P + i * AP + b0);
            yy[i] = ld4(y + (b0 + i) * SCP);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int s = 0; s < 4; ++s)
                d[i][s] = __fmaf_rn(comp(pp[i], j), comp(yy[j], s), d[i][s]);
        }
        float* out = (side ? dm2 : dm1) + (size_t)(tg * A + ta) * S + c0 +
                     st * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ta + i < A)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (c0 + st * 4 + s < S) out[(size_t)i * S + s] = d[i][s];
      }
    }
    // dP_l[g, a, b] += sum_s x1[a, s] du[b, s]; dP_r with x2, dv
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int t = tid + j * NT;
      if (t < ntiles) {
        const int side = t / (G * NPT * NPT);
        const int rem = t - side * G * NPT * NPT;
        const int g = rem / (NPT * NPT), ab = rem - g * NPT * NPT;
        const int ai = ab / NPT, bi = ab - ai * NPT;
        const float* X = (side ? x2 : x1) + (g * AP + ai * 4) * SCP;
        const float* Y = (side ? dv : gd) + (g * AP + bi * 4) * SCP;
        for (int s0 = 0; s0 < SC; s0 += 4) {
          float4 xx[4], yy[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xx[i] = ld4(X + i * SCP + s0);
            yy[i] = ld4(Y + i * SCP + s0);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[j][i * 4 + jj] = __fmaf_rn(comp(xx[i], s),
                                               comp(yy[jj], s),
                                               acc[j][i * 4 + jj]);
        }
      }
    }
    __syncthreads();
  }

  // the block's dP and dpi row in shared memory (P's region is free)
  float* stage = smem;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int t = tid + j * NT;
    if (t < ntiles) {
      const int side = t / (G * NPT * NPT);
      const int rem = t - side * G * NPT * NPT;
      const int g = rem / (NPT * NPT), ab = rem - g * NPT * NPT;
      const int ai = ab / NPT, bi = ab - ai * NPT;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int a = ai * 4 + i, b = bi * 4 + jj;
          if (a < A && b < A)
            stage[side * GAA + g * AA + a * A + b] = acc[j][i * 4 + jj];
        }
    }
  }
  if (tile)
#pragma unroll
    for (int i = 0; i < 4; ++i) dpis[st * GAP + prow + i] = dpa[i];
  __syncthreads();
  for (int p = tid; p < GA; p += NT) {
    const int row = (p / A) * AP + p % A;
    float t = 0.f;
    for (int q = 0; q < NST; ++q) t += dpis[q * GAP + row];
    stage[2 * GAA + p] = t;
  }
  cluster.sync();                       // every rank's row is staged
  // rank r sums its slice of float4 groups of every rank's row, the C
  // ranks' loads issued together, added in rank order
  const int E = 2 * GAA + GA, E4 = (E + 3) / 4;
  const int lo = (int)((long long)E4 * r / C);
  const int hi = (int)((long long)E4 * (r + 1) / C);
  for (int e4 = lo + tid; e4 < hi; e4 += NT) {
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) v[q] = ld4(cluster.map_shared_rank(stage, q) + 4 * e4);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] += comp(v[q], i);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * e4 + i;
      if (e < GAA)
        dPl[(size_t)k * GAA + e] = t[i];
      else if (e < 2 * GAA)
        dPr[(size_t)k * GAA + e - GAA] = t[i];
      else if (e < E)
        dpi_part[(size_t)k * GA + e - 2 * GAA] = t[i];
    }
  }
  cluster.sync();                       // no rank leaves while read
}

size_t fwd_smem(int GA, int GAA) {
  return (size_t)(2 * GAA + GA + 3 * GA * kPitch + kTile) * sizeof(float);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool planes_ok(int G, int A) {
  return A >= 1 && G >= 1 && G * A <= kMaxPlanes;
}

template <bool Gather, int DPT, int NST>
int run_bwd(const float* m1, const float* m2, const float* leaves,
            const float* buf, const int* idx, const float* gm,
            const float* gr, const float* gl, const float* Pl,
            const float* Pr, const float* pi, const float* w, float* dm1,
            float* dm2, float* dPl, float* dPr, float* dpi_part,
            float* dw_part, int K, int R, int N, int G, int A, int S,
            int cluster, int threads, cudaStream_t st) {
  const size_t smem = (size_t)BwdLayout(G, A, NST).total * sizeof(float);
  auto kernel = wide_rank_bwd_kernel<Gather, DPT, NST>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, K, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1,
      dm2, dPl, dPr, dpi_part, dw_part, K, R, N, G, A, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan (pruning/kernels.py::wide_bwd_plan): chunks of `sc` sites (32,
// or 16 where G ceil(A / 4) plane tiles exceed 32: a blocked model with a
// padded A, such as 14 x 9), `cluster` blocks a particle (1..8, at most
// its chunks), `threads` a block (a multiple of 32 covering the G ceil(A /
// 4) x sc / 4 tiles), `dpt` dP tiles a thread (dpt * threads covers the
// 2 G ceil(A / 4)^2 tiles).
template <bool Gather>
int launch_bwd(const float* m1, const float* m2, const float* leaves,
               const float* buf, const int* idx, const float* gm,
               const float* gr, const float* gl, const float* Pl,
               const float* Pr, const float* pi, const float* w, float* dm1,
               float* dm2, float* dPl, float* dPr, float* dpi_part,
               float* dw_part, int K, int R, int N, int G, int A, int S,
               int sc, int cluster, int threads, int dpt, void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (!planes_ok(G, A) || (sc != 32 && sc != 16))
    return (int)cudaErrorInvalidValue;
  const int npt = (A + 3) / 4, nst = sc / 4;
  const int nch = (S + sc - 1) / sc;
  if (cluster < 1 || cluster > kMaxCluster || cluster > nch ||
      threads % 32 || threads < G * npt * nst ||
      threads > bwd_max_threads(nst) ||
      (long long)dpt * threads < 2 * G * npt * npt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHYLO_RUN_BWD(D, NST)                                               \
  return run_bwd<Gather, D, NST>(m1, m2, leaves, buf, idx, gm, gr, gl, Pl,  \
                                 Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part,   \
                                 dw_part, K, R, N, G, A, S, cluster,        \
                                 threads, st)
  if (nst == 8) {
    switch (dpt) {
      case 1: PHYLO_RUN_BWD(1, 8);
      case 2: PHYLO_RUN_BWD(2, 8);
      case 4: PHYLO_RUN_BWD(4, 8);
      case 8: PHYLO_RUN_BWD(8, 8);
    }
  } else {
    switch (dpt) {
      case 1: PHYLO_RUN_BWD(1, 4);
      case 2: PHYLO_RUN_BWD(2, 4);
      case 4: PHYLO_RUN_BWD(4, 4);
    }
  }
#undef PHYLO_RUN_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int launch_wide_rank(const float* leaves, float* buf,
                                const int* idx, const float* Pl,
                                const float* Pr, const float* pi,
                                const float* w, float* rootll_part,
                                float* logscale_part, float* c1, float* c2,
                                int K, int R, int N, int G, int A, int S,
                                int outc, void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (!planes_ok(G, A)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(G * A, G * A * A);
  const int err = allow_smem(wide_rank_kernel, smem);
  if (err) return err;
  const dim3 grid(K, (S + kTile - 1) / kTile);
  wide_rank_kernel<<<grid, kFwdThreads, smem, st>>>(
      leaves, buf, idx, Pl, Pr, pi, w, rootll_part, logscale_part, c1, c2, K,
      R, N, G, A, S, outc);
  return (int)cudaGetLastError();
}

extern "C" int launch_wide_rank_bwd_saved(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, int K, int G, int A, int S, int sc,
    int cluster, int threads, int dpt, void* stream) {
  return launch_bwd<false>(m1, m2, nullptr, nullptr, nullptr, gm, gr, gl, Pl,
                           Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part, dw_part,
                           K, 0, 0, G, A, S, sc, cluster, threads, dpt,
                           stream);
}

extern "C" int launch_wide_rank_bwd(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, int K, int R, int N, int G,
    int A, int S, int sc, int cluster, int threads, int dpt, void* stream) {
  return launch_bwd<true>(nullptr, nullptr, leaves, buf, idx, gm, gr, gl, Pl,
                          Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part, dw_part, K,
                          R, N, G, A, S, sc, cluster, threads, dpt, stream);
}
