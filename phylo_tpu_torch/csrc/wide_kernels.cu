// Kernels K9 of phylo_tpu_torch: the wide bodies of the rank update and
// its two backwards, for messages of 8 < A <= 128 states per block and
// 1 <= G <= 32 blocks: dense (G = 1; codon GY94: A = 61) and blocked
// (G > 1, a rate mixture over a wide base; protein + Gamma4: G = 4,
// A = 20, 80 planes; protein + Gamma8: 160; GY94 + Gamma4: 4 x 61, 244).
// Where one block of threads holds every plane of a chunk (the one-group
// bodies) they run as before; elsewhere the block-group bodies below take
// the planes a group of whole rate blocks at a time.
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
// bytes bound (chip_smoke.py computes the bound of each launch).  The
// TPU ran the contractions on its MXU in a multi-pass exact-f32
// emulation; here they are FP32 FMAs on the CUDA cores (no tensor cores:
// no TF32, no wgmma), in a fixed order.
//
// One grid for all three: (cluster of up to 8 blocks, particle).  The
// blocks of particle k split its chunks of SC sites (block r takes chunks
// r, r + C, ...); each stages P_l, P_r (as (G, AP, AP) zero-padded
// blocks, AP = 4 ceil(A / 4)) and pi in shared memory once and loops over
// its chunks, whose children it stages by cp.async.  A thread owns a
// (4 planes x TS sites) register tile of u and v, computed by `uv_tile`
// from float4 operands (a float4 of P_l[a, b0..b0+3] and TS / 4 of
// x1[a, ...] feed 4 TS FMAs a side), one FMA chain per (plane, site), a
// ascending from 0: the forward and the backwards compute the same bits,
// so the backward's tie test w == max sees the forward's.  The per-site
// scalars (max, pi-sum) are reduced over the warp's plane tiles by xor
// shuffles and over the warps in warp order; a particle's sums over its
// blocks go through distributed shared memory in rank order and are
// written once.  No float atomics: two calls give the same bits.  The
// launch plans are pruning/kernels.py's wide_fwd_plan and wide_bwd_plan;
// each launcher checks the plan it is given.
//
// K9f (wide_rank_fwd_kernel).  Per chunk three barriers: (1) the
// chunk's tiles have landed (with save_children each thread first copies
// the elements it staged to the saved children: the same bits); (2) u, v
// and the tile's max and pi-sum partials, combined over the warp's plane
// tiles and written per warp; then the next chunk's copies are issued
// into the same tiles and land while (3) one thread a site combines the
// warps in order, keeps the clamped max and adds w_s log(site) and w_s
// log(scale) to its running sums, and each thread writes its tile's
// w / scale (an IEEE division: the plain version's bits for the same w)
// into buffer column outc IN PLACE (never among the columns read).
// After the last chunk the block's sums (lanes by shuffles, warps in
// order) and the cluster's (ranks in order) give rootll[k] and
// logscale[k]: one launch a call.  The children come in cp.async copies
// of 16 bytes where S % 4 == 0, of 8 where S is even (the column write
// likewise), and P by 16-byte loads (stage_p16) while the first chunk is
// in flight: a block holds one to a few chunks, so its prologue is a
// large share of its time.  The former K9f ran one block per 32-site
// tile, restaging all of P for each, took a shared-memory operand for
// every FMA, reduced each site on warp 0 alone and left per-tile partial
// rows to a torch.sum.
//
// The backward (K9bs, K9b, K11a above 8 states).  The former form ran
// one block per particle over the site tiles in turn (128 blocks at GY94,
// 32 at K11a), the per-site scalars on warp 0 alone, and every FMA of its
// three contractions with a shared-memory operand (the card's shared
// memory serves 32 floats a clock an SM against 128 FMA lanes): 13.5x its
// bound at GY94.  Now each thread computes (4 x 4) register tiles of each
// contraction, 8 FMAs a shared-memory load; dP sums over a block's chunks
// in registers and over the cluster's blocks in rank order through
// distributed shared memory, written once (wide_rank_bwd_kernel says each
// step).  Its site and gm-sums run per 4-plane tile, then over tiles, then
// warps, as K9f's site sum does.  dpi and dw come back as per-particle
// partial rows.
// Every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxStates = 128;      // A, states a block
constexpr int kMaxBlocks = 32;       // G, rate blocks
constexpr int kGroupDpt = 4;         // group backward: dP tiles a thread a round
constexpr int kMaxCluster = 8;       // blocks a particle (portable)
constexpr int kFwdMaxThreads = 256;  // K9f: threads a block at most

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

// W = 1, 2 or 4 consecutive floats (both addresses 4 W-byte aligned).
template <int W>
__device__ __forceinline__ void cp_async_w(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if (W == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// W consecutive floats from src to dst (both 4 W-byte aligned).
template <int W>
__device__ __forceinline__ void copy_w(float* dst, const float* src) {
  if (W == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else if (W == 2)
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  else
    *dst = *src;
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

// Four floats at a 16-byte-aligned address.
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

// u[i][s] += sum_a x1[a, s] P_l[a, b0 + i] and v[i][s] likewise with x2,
// P_r, for the 4 planes b0.. and TS sites of a thread's tile: pla, pra
// point at P's block + b0 (rows of pitch AP), y1, y2 at the block's tile
// rows + the tile's first site (pitch SCP); the caller zeroes u, v.  One
// FMA chain per (plane, site), a ascending from 0: K9f, K9bs and K9b
// compute the same bits.
template <int TS>
__device__ __forceinline__ void uv_tile(const float* pla, const float* pra,
                                        const float* y1, const float* y2,
                                        int A, int AP, int SCP,
                                        float (&u)[4][TS],
                                        float (&v)[4][TS]) {
#pragma unroll 4
  for (int a = 0; a < A; ++a) {
    const float4 p1 = ld4(pla + a * AP), p2 = ld4(pra + a * AP);
#pragma unroll
    for (int h = 0; h < TS / 4; ++h) {
      const float4 z1 = ld4(y1 + a * SCP + 4 * h);
      const float4 z2 = ld4(y2 + a * SCP + 4 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          u[i][4 * h + s] =
              __fmaf_rn(comp(z1, s), comp(p1, i), u[i][4 * h + s]);
          v[i][4 * h + s] =
              __fmaf_rn(comp(z2, s), comp(p2, i), v[i][4 * h + s]);
        }
    }
  }
}

// Particle k's P_l, P_r into shared memory as (G, AP, AP) blocks by
// cp.async (the caller waits), the padding zeroed.
__device__ __forceinline__ void stage_p(float* pl, float* pr,
                                        const float* Pl, const float* Pr,
                                        int k, int G, int A, int AP, int tid,
                                        int NT) {
  const int AA = A * A, GAA = G * AA;
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

// K9f's P_l, P_r of particle k into shared memory as (G, AP, AP)
// zero-padded blocks: 16-byte loads of the flat (G, A, A) arrays (4-byte
// ones at their misaligned ends), every element stored at its padded
// place.  Fewer, wider requests than stage_p's 4-byte copies: K9f's
// prologue waits on them (the backward, not redesigned here, keeps
// stage_p).
__device__ __forceinline__ void stage_p16(float* pl, float* pr,
                                          const float* Pl, const float* Pr,
                                          int k, int G, int A, int AP,
                                          int tid, int NT) {
  const int AA = A * A, GAA = G * AA, pad = AP - A;
  for (int e = tid; e < G * pad * AP; e += NT) {     // rows a >= A
    const int g = e / (pad * AP), rem = e - g * pad * AP;
    const int i = (g * AP + A + rem / AP) * AP + rem % AP;
    pl[i] = pr[i] = 0.f;
  }
  for (int e = tid; e < G * A * pad; e += NT) {      // columns b >= A
    const int row = e / pad, b = A + e % pad;       // row = g A + a
    const int g = row / A;
    const int i = (g * AP + row - g * A) * AP + b;
    pl[i] = pr[i] = 0.f;
  }
  // f = g AA + a A + b by float reciprocals: f < 2^14, so each quotient
  // lies at least 0.5 / AA from an integer, far above the rounding
  const float invAA = 1.f / AA, invA = 1.f / A;
  auto place = [&](float* dst, int f, float x) {
    const int g = (int)((f + 0.5f) * invAA), r = f - g * AA;
    const int a = (int)((r + 0.5f) * invA);
    dst[(g * AP + a) * AP + r - a * A] = x;
  };
  const float* src[2] = {Pl + (size_t)k * GAA, Pr + (size_t)k * GAA};
  float* dst[2] = {pl, pr};
  int hd[2], n4[2];
  for (int q = 0; q < 2; ++q) {
    const int h = (int)(((16 - (reinterpret_cast<uintptr_t>(src[q]) & 15)) &
                         15) >> 2);
    hd[q] = h < GAA ? h : GAA;
    n4[q] = (GAA - hd[q]) >> 2;
  }
#pragma unroll 4
  for (int i = tid; i < n4[0] + n4[1]; i += NT) {
    const int q = i >= n4[0], j = i - (q ? n4[0] : 0);
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(src[q] + hd[q]) + j);
    const int f = hd[q] + 4 * j;
    place(dst[q], f, v.x);
    place(dst[q], f + 1, v.y);
    place(dst[q], f + 2, v.z);
    place(dst[q], f + 3, v.w);
  }
  for (int q = 0; q < 2; ++q) {
    for (int f = tid; f < hd[q]; f += NT) place(dst[q], f, src[q][f]);
    for (int f = hd[q] + 4 * n4[q] + tid; f < GAA; f += NT)
      place(dst[q], f, src[q][f]);
  }
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

  stage_p(pl, pr, Pl, Pr, k, G, A, AP, tid, NT);
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
      uv_tile<4>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                 x1 + tg * AP * SCP + st * 4, x2 + tg * AP * SCP + st * 4,
                 A, AP, SCP, u, v);
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

// Shared-memory layout of K9f (floats; every region 16-byte aligned):
// P_l, P_r as (G, AP, AP) zero-padded blocks; pi; the chunk's x1, x2
// tiles (G*AP, SC) at pitch SC + 4; the warps' per-site partials (2 x
// warps x SC); the per-site scales (SC); the block's site-sum slots.
struct FwdLayout {
  int AP, tile, pv, x1, wpart, ssc, red, total;
  __host__ __device__ FwdLayout(int G, int A, int SC, int NW) {
    AP = (A + 3) & ~3;
    tile = G * AP * (SC + 4);
    pv = 2 * G * AP * AP;
    x1 = pv + ((G * A + 3) & ~3);       // then x2 a tile apart
    wpart = x1 + 2 * tile;
    ssc = wpart + 2 * NW * SC;
    red = ssc + SC;
    total = red + 16;
  }
};

// K9f.  grid (C, K), a cluster of the C blocks of particle k =
// blockIdx.y; block r takes the chunks c = r, r + C, ... of SC = TS NST
// sites.  Its threads are (plane tile pt, site tile st) pairs, tid = pt
// NST + st, for the G ceil(A / 4) tiles of 4 planes and the NST tiles of
// TS sites.  rootll, logscale (K,); c1, c2 (K, G*A, S) or null.  The
// launch bound asks for MINB blocks of 256 threads an SM (2: at most 128
// registers a thread); the launcher runs TS = 4, MINB = 2, and
// tools/torch_k9_fwd_forms.py times the other forms.
template <int TS, int NST, int MINB = 2>
__global__ void __launch_bounds__(kFwdMaxThreads, MINB) wide_rank_fwd_kernel(
    const float* __restrict__ leaves, float* buf,
    const int* __restrict__ idx, const float* __restrict__ Pl,
    const float* __restrict__ Pr, const float* __restrict__ pi,
    const float* __restrict__ w, float* __restrict__ rootll,
    float* __restrict__ logscale, float* __restrict__ c1,
    float* __restrict__ c2, int K, int R, int N, int G, int A, int S,
    int outc) {
  constexpr int SC = TS * NST, SCP = SC + 4;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, NT = blockDim.x, NW = NT >> 5;
  const int lane = tid & 31, wid = tid >> 5;
  const FwdLayout L(G, A, SC, NW);
  const int AP = L.AP, NPT = AP / 4, GT = G * NPT, GA = G * A;
  const int C = gridDim.x, r = blockIdx.x, k = blockIdx.y;
  float* pl = smem;
  float* pr = smem + G * AP * AP;
  float* pv = smem + L.pv;
  float* x1 = smem + L.x1;
  float* x2 = x1 + L.tile;
  float* wpart = smem + L.wpart;
  float* ssc = smem + L.ssc;
  float* red = smem + L.red;
  const size_t slab = (size_t)GA * S;

  for (int c = tid; c < GA; c += NT) pv[c] = pi[c];
  for (int e = tid; e < (AP - A) * G * SC; e += NT) {  // padded planes
    const int row = e / SC, s = e - row * SC;
    const int g = row / (AP - A), a = A + row % (AP - A);
    x1[(g * AP + a) * SCP + s] = 0.f;
    x2[(g * AP + a) * SCP + s] = 0.f;
  }
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float* s1 = c1 ? c1 + (size_t)k * slab : nullptr;
  float* s2 = c2 ? c2 + (size_t)k * slab : nullptr;
  float* out = buf + ((size_t)k * R + outc) * slab;

  const int pt = tid / NST, st = tid - pt * NST;
  const bool tile = pt < GT;
  const int tg = tile ? pt / NPT : 0;   // the tile's block
  const int ta = (pt - tg * NPT) * 4;   // its first plane within the block
  const int nch = (S + SC - 1) / SC;
  // copies of W = 4 (16 bytes), 2 or 1 floats, as wide as every row of a
  // chunk is aligned
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(leaves) |
                         reinterpret_cast<uintptr_t>(buf) |
                         reinterpret_cast<uintptr_t>(c1) |
                         reinterpret_cast<uintptr_t>(c2);
  const int width = (S & 3) == 0 && (ptrs & 15) == 0  ? 4
                    : (S & 1) == 0 && (ptrs & 7) == 0 ? 2
                                                      : 1;
  // chunk c's x1, x2 by cp.async, zeros past S; with `save` (after the
  // copies have landed) the thread's own staged elements to the saved
  // children instead
  auto copy = [&](int c, auto save, auto w) {
    constexpr int W = decltype(w)::value, PER = SC / W;
    const int step = NT / PER;          // planes a pass
    const int s = (tid % PER) * W, gs = c * SC + s;
    int g = 0, a = tid / PER;
    for (int p = a; p < GA; p += step) {
      while (a >= A) {                  // p = g A + a without a division
        a -= A;
        ++g;
      }
      const int o = (g * AP + a) * SCP + s;
      if (gs < S) {                     // S % W == 0: all W sites below S
        const size_t src = (size_t)p * S + gs;
        if (decltype(save)::value) {
          copy_w<W>(s1 + src, x1 + o);
          copy_w<W>(s2 + src, x2 + o);
        } else {
          cp_async_w<W>(x1 + o, m1 + src);
          cp_async_w<W>(x2 + o, m2 + src);
        }
      } else if (!decltype(save)::value) {
#pragma unroll
        for (int j = 0; j < W; ++j) x1[o + j] = x2[o + j] = 0.f;
      }
      a += step;
    }
  };
  // copy(c, save) at the chunk's width
  auto copy_at = [&](int c, auto save) {
    if (width == 4)
      copy(c, save, std::integral_constant<int, 4>{});
    else if (width == 2)
      copy(c, save, std::integral_constant<int, 2>{});
    else
      copy(c, save, std::integral_constant<int, 1>{});
  };

  float racc0 = 0.f, racc1 = 0.f;       // thread s < SC: its sites' sums
  if (r < nch) copy_at(r, std::false_type{});  // the first chunk in flight,
  stage_p16(pl, pr, Pl, Pr, k, G, A, AP, tid, NT);  // then P
  for (int c = r; c < nch; c += C) {
    const int c0 = c * SC;
    cp_async_wait_all();
    if (s1) copy_at(c, std::true_type{});
    __syncthreads();                    // (1) the chunk's tiles are in

    // (2) u, v and the partial per-site max and pi-sum over the tile's
    // real planes
    float u[4][TS], v[4][TS], praw[TS], psite[TS];
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      praw[s] = __int_as_float(0xff800000);  // -inf
      psite[s] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
    }
    if (tile) {
      uv_tile<TS>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                  x1 + tg * AP * SCP + st * TS, x2 + tg * AP * SCP + st * TS,
                  A, AP, SCP, u, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ta + i < A) {
          const float piv = pv[tg * A + ta + i];
#pragma unroll
          for (int s = 0; s < TS; ++s) {
            const float x = __fmul_rn(u[i][s], v[i][s]);
            psite[s] = __fmaf_rn(x, piv, psite[s]);
            praw[s] = fmaxf(praw[s], x);
          }
        }
      }
    }
    // over the warp's plane tiles of one site tile: lanes st + NST q
#pragma unroll
    for (int o = NST; o < 32; o <<= 1)
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const float rr = __shfl_xor_sync(0xffffffffu, praw[s], o);
        const float ss = __shfl_xor_sync(0xffffffffu, psite[s], o);
        praw[s] = fmaxf(praw[s], rr);
        psite[s] = psite[s] + ss;
      }
    if (lane < NST)
#pragma unroll
      for (int h = 0; h < TS / 4; ++h) {
        const int e = st * TS + 4 * h;
        st4(wpart + wid * SC + e, praw[4 * h], praw[4 * h + 1],
            praw[4 * h + 2], praw[4 * h + 3]);
        st4(wpart + (NW + wid) * SC + e, psite[4 * h], psite[4 * h + 1],
            psite[4 * h + 2], psite[4 * h + 3]);
      }
    __syncthreads();                    // (2) no thread reads the tiles now
    if (c + C < nch)                    // lands during (3) and the write
      copy_at(c + C, std::false_type{});

    // (3) one thread a site: the warps' partials in warp order
    if (tid < SC) {
      const int gs = c0 + tid;
      float raw = __int_as_float(0xff800000);
      for (int q = 0; q < NW; ++q) raw = fmaxf(raw, wpart[q * SC + tid]);
      float site = 0.f;
      for (int q = 0; q < NW; ++q) site = site + wpart[(NW + q) * SC + tid];
      const float scale = fmaxf(raw, FLT_MIN);
      ssc[tid] = scale;
      if (gs < S) {
        const float ws = w[gs];
        racc0 += logf(site) * ws;
        racc1 += logf(scale) * ws;
      }
    }
    __syncthreads();                    // (3) the chunk's scales are in

    // w / scale of the thread's tile into column outc
    if (tile) {
      float scl[TS];
#pragma unroll
      for (int h = 0; h < TS / 4; ++h) {
        const float4 q = ld4(ssc + st * TS + 4 * h);
#pragma unroll
        for (int s = 0; s < 4; ++s) scl[4 * h + s] = comp(q, s);
      }
      const int s0 = c0 + st * TS;
      float* o = out + (size_t)(tg * A + ta) * S + s0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ta + i < A) {
          float* oi = o + (size_t)i * S;
#pragma unroll
          for (int h = 0; h < TS / 4; ++h) {
            float y[4];
#pragma unroll
            for (int s = 0; s < 4; ++s)
              y[s] = __fdiv_rn(__fmul_rn(u[i][4 * h + s], v[i][4 * h + s]),
                               scl[4 * h + s]);
            if (width == 4 && s0 + 4 * h < S) {
              st4(oi + 4 * h, y[0], y[1], y[2], y[3]);
            } else if (width == 2 && s0 + 4 * h + 2 < S) {
              *reinterpret_cast<float2*>(oi + 4 * h) = make_float2(y[0], y[1]);
              *reinterpret_cast<float2*>(oi + 4 * h + 2) =
                  make_float2(y[2], y[3]);
            } else {
#pragma unroll
              for (int s = 0; s < 4; ++s)
                if (s0 + 4 * h + s < S) oi[4 * h + s] = y[s];
            }
          }
        }
      }
    }
  }

  // the block's sums: lanes by shuffles, the site warps in order
  if (tid < ((SC + 31) & ~31)) {
    float a0 = tid < SC ? racc0 : 0.f, a1 = tid < SC ? racc1 : 0.f;
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      red[2 * wid] = a0;
      red[2 * wid + 1] = a1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = 0.f, t1 = 0.f;
    for (int q = 0; q < (SC + 31) / 32; ++q) {
      t0 += red[2 * q];
      t1 += red[2 * q + 1];
    }
    red[8] = t0;
    red[9] = t1;
  }
  cluster.sync();                       // every rank's sums are staged
  if (r == 0 && tid == 0) {             // rank 0 adds them in rank order
    float t0 = 0.f, t1 = 0.f;
    for (int q = 0; q < C; ++q) {
      const float* o = cluster.map_shared_rank(red, q);
      t0 += o[8];
      t1 += o[9];
    }
    rootll[k] = t0;
    logscale[k] = t1;
  }
  cluster.sync();                       // no rank leaves while it is read
}

// ---------------------------------------------------------------------
// The block-group bodies.  Where a chunk's planes do not fit one block of
// threads (more than 256 tiles of 4 planes x the site tiles: 32 x 20), its
// shared memory (all of P: 8 x 61) or, in the backward, a thread's dP
// registers (4 x 61 would hold 128 accumulators a thread), a block takes
// its particle's planes a group of GB whole rate blocks at a time: only
// the group's P blocks and child tiles are staged.  Each site's max and
// pi-sum need every plane, and the write of w / scale (the forward) and
// du, dv (the backward) need them, so each body makes two passes over the
// groups: pass A computes the per-site scalars, pass B recomputes u and v
// with the same `uv_tile` chains (the same bits as pass A and as the
// one-group bodies) and finishes.  A pass restages P once a group, not
// once a chunk.  The sums across groups are chains in group order, the
// launch's site chunks split over a cluster as in the one-group bodies,
// no float atomics: two calls give the same bits.
//
// K9f's group form keeps each site's running max and pi-sum in a (K, 2,
// S_pad) scratch (S_pad = the chunks' sites), one thread a site adding
// each group's warp partials in warp order; after the last group the same
// thread keeps the clamped max (the scale) there and adds the site's
// w_s log(site) and w_s log(scale) to its running sums.  Pass B writes
// w / scale: the max is exact, so the column has the one-group body's
// bits; rootll and logscale differ from it only in the order of the
// pi-sum's terms.
//
// The backward's group form (K9bs, K9b, K11a) writes each (4-plane tile,
// site) partial of pass A -- max, tie count, pi-sum, gm-sum, as the
// one-group body forms them -- to a (K, 4, G ceil(A / 4), S_pad) scratch;
// one thread a site then rebuilds the one-group body's order from them
// (the xor butterfly over each warp's 32 / NST tiles, then the warps in
// order), so that dsite, dscale and the tie shares, and with them dm and
// dP, have the one-group body's bits at the same chunk size and cluster.
// The site's five scalars go to a (K, 5, S_pad) scratch.  Pass B runs
// each group in rounds of kGroupDpt dP tiles a thread: dP of a block needs
// only its own planes, so a round's tiles sum over the block's chunks in
// registers and over the cluster's blocks through distributed shared
// memory, written once; dm and dpi come in the first round.

// Shared-memory layout of K9f's group form (floats; every region 16-byte
// aligned): the group's P_l, P_r as (GB, AP, AP) zero-padded blocks; its
// pi; the chunk's x1, x2 tiles of the group's planes (GB*AP, SC) at pitch
// SC + 4; the warps' per-site partials (2 x warps x SC); the block's
// site-sum slots.
struct FwdGroupLayout {
  int AP, tile, pv, x1, wpart, red, total;
  __host__ __device__ FwdGroupLayout(int GB, int A, int SC, int NW) {
    AP = (A + 3) & ~3;
    tile = GB * AP * (SC + 4);
    pv = 2 * GB * AP * AP;
    x1 = pv + ((GB * A + 3) & ~3);      // then x2 a tile apart
    wpart = x1 + 2 * tile;
    red = wpart + 2 * NW * SC;
    total = red + 16;
  }
};

// K9f's group form.  grid (C, K) as wide_rank_fwd_kernel; groups of GB
// blocks (the last one may hold fewer); threads (plane tile pt, site tile
// st), tid = pt NST + st, over the group's tiles.  scr (K, 2, S_pad).
template <int NST>
__global__ void __launch_bounds__(kFwdMaxThreads, 2)
    wide_rank_fwd_group_kernel(
        const float* __restrict__ leaves, float* buf,
        const int* __restrict__ idx, const float* __restrict__ Pl,
        const float* __restrict__ Pr, const float* __restrict__ pi,
        const float* __restrict__ w, float* __restrict__ rootll,
        float* __restrict__ logscale, float* __restrict__ c1,
        float* __restrict__ c2, float* scr, int K, int R, int N, int G,
        int A, int S, int outc, int GB) {
  constexpr int TS = 4, SC = TS * NST, SCP = SC + 4;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, NT = blockDim.x, NW = NT >> 5;
  const int lane = tid & 31, wid = tid >> 5;
  const FwdGroupLayout L(GB, A, SC, NW);
  const int AP = L.AP, NPT = AP / 4, GA = G * A, AA = A * A;
  const int C = gridDim.x, r = blockIdx.x, k = blockIdx.y;
  float* pl = smem;
  float* pr = smem + GB * AP * AP;
  float* pv = smem + L.pv;
  float* x1 = smem + L.x1;
  float* x2 = x1 + L.tile;
  float* wpart = smem + L.wpart;
  float* red = smem + L.red;
  const size_t slab = (size_t)GA * S;
  const int nch = (S + SC - 1) / SC, Sp = nch * SC;
  float* sraw = scr + (size_t)k * 2 * Sp;  // running max, then the scale
  float* ssite = sraw + Sp;                // running pi-sum

  for (int e = tid; e < (AP - A) * GB * SC; e += NT) {  // padded planes
    const int row = e / SC, s = e - row * SC;
    const int g = row / (AP - A), a = A + row % (AP - A);
    x1[(g * AP + a) * SCP + s] = 0.f;
    x2[(g * AP + a) * SCP + s] = 0.f;
  }
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float* s1 = c1 ? c1 + (size_t)k * slab : nullptr;
  float* s2 = c2 ? c2 + (size_t)k * slab : nullptr;
  float* out = buf + ((size_t)k * R + outc) * slab;

  const int pt = tid / NST, st = tid - pt * NST;
  const int tg = pt / NPT;              // the tile's block in its group
  const int ta = (pt - tg * NPT) * 4;   // its first plane within the block
  const int NG = (G + GB - 1) / GB;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(leaves) |
                         reinterpret_cast<uintptr_t>(buf) |
                         reinterpret_cast<uintptr_t>(c1) |
                         reinterpret_cast<uintptr_t>(c2);
  const int width = (S & 3) == 0 && (ptrs & 15) == 0  ? 4
                    : (S & 1) == 0 && (ptrs & 7) == 0 ? 2
                                                      : 1;
  // chunk c's x1, x2 of the group's planes (gb blocks from block g0) by
  // cp.async, zeros past S; with `save`, the thread's own staged elements
  // to the saved children instead
  auto copy = [&](int c, int g0, int gb, auto save, auto w) {
    constexpr int W = decltype(w)::value, PER = SC / W;
    const int step = NT / PER;          // planes a pass
    const int s = (tid % PER) * W, gs = c * SC + s;
    int g = 0, a = tid / PER;
    for (int p = a; p < gb * A; p += step) {
      while (a >= A) {                  // p = g A + a without a division
        a -= A;
        ++g;
      }
      const int o = (g * AP + a) * SCP + s;
      if (gs < S) {
        const size_t src = (size_t)(g0 * A + p) * S + gs;
        if (decltype(save)::value) {
          copy_w<W>(s1 + src, x1 + o);
          copy_w<W>(s2 + src, x2 + o);
        } else {
          cp_async_w<W>(x1 + o, m1 + src);
          cp_async_w<W>(x2 + o, m2 + src);
        }
      } else if (!decltype(save)::value) {
#pragma unroll
        for (int j = 0; j < W; ++j) x1[o + j] = x2[o + j] = 0.f;
      }
      a += step;
    }
  };
  auto copy_at = [&](int c, int g0, int gb, auto save) {
    if (width == 4)
      copy(c, g0, gb, save, std::integral_constant<int, 4>{});
    else if (width == 2)
      copy(c, g0, gb, save, std::integral_constant<int, 2>{});
    else
      copy(c, g0, gb, save, std::integral_constant<int, 1>{});
  };
  auto load_p = [&](int g0, int gb) {
    stage_p16(pl, pr, Pl + ((size_t)k * G + g0) * AA,
              Pr + ((size_t)k * G + g0) * AA, 0, gb, A, AP, tid, NT);
  };

  // pass A: each site's max and pi-sum, group after group
  float racc0 = 0.f, racc1 = 0.f;       // thread s < SC: its sites' sums
  for (int q = 0; q < NG; ++q) {
    const int g0 = q * GB, gb = min(GB, G - g0);
    const bool tile = pt < gb * NPT;
    __syncthreads();                    // the former group's P is free
    load_p(g0, gb);
    for (int c = tid; c < gb * A; c += NT) pv[c] = pi[g0 * A + c];
    for (int c = r; c < nch; c += C) {
      const int c0 = c * SC;
      copy_at(c, g0, gb, std::false_type{});
      cp_async_wait_all();
      __syncthreads();                  // the chunk's tiles (and P) are in
      float u[4][TS], v[4][TS], praw[TS], psite[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        praw[s] = __int_as_float(0xff800000);  // -inf
        psite[s] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
      }
      if (tile) {
        uv_tile<TS>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                    x1 + tg * AP * SCP + st * TS,
                    x2 + tg * AP * SCP + st * TS, A, AP, SCP, u, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ta + i < A) {
            const float piv = pv[tg * A + ta + i];
#pragma unroll
            for (int s = 0; s < TS; ++s) {
              const float x = __fmul_rn(u[i][s], v[i][s]);
              psite[s] = __fmaf_rn(x, piv, psite[s]);
              praw[s] = fmaxf(praw[s], x);
            }
          }
        }
      }
#pragma unroll
      for (int o = NST; o < 32; o <<= 1)
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const float rr = __shfl_xor_sync(0xffffffffu, praw[s], o);
          const float ss = __shfl_xor_sync(0xffffffffu, psite[s], o);
          praw[s] = fmaxf(praw[s], rr);
          psite[s] = psite[s] + ss;
        }
      if (lane < NST)
#pragma unroll
        for (int h = 0; h < TS / 4; ++h) {
          const int e = st * TS + 4 * h;
          st4(wpart + wid * SC + e, praw[4 * h], praw[4 * h + 1],
              praw[4 * h + 2], praw[4 * h + 3]);
          st4(wpart + (NW + wid) * SC + e, psite[4 * h], psite[4 * h + 1],
              psite[4 * h + 2], psite[4 * h + 3]);
        }
      __syncthreads();                  // no thread reads the tiles now
      // one thread a site: the warps in order, then the former groups'
      if (tid < SC) {
        const int s = c0 + tid;
        float raw = __int_as_float(0xff800000);
        for (int j = 0; j < NW; ++j) raw = fmaxf(raw, wpart[j * SC + tid]);
        float site = 0.f;
        for (int j = 0; j < NW; ++j) site = site + wpart[(NW + j) * SC + tid];
        if (q) {
          raw = fmaxf(sraw[s], raw);
          site = ssite[s] + site;
        }
        if (q + 1 < NG) {
          sraw[s] = raw;
          ssite[s] = site;
        } else {
          const float scale = fmaxf(raw, FLT_MIN);
          sraw[s] = scale;
          if (s < S) {
            const float ws = w[s];
            racc0 += logf(site) * ws;
            racc1 += logf(scale) * ws;
          }
        }
      }
    }
  }

  // pass B: u, v again a group at a time, w / scale into column outc
  for (int q = 0; q < NG; ++q) {
    const int g0 = q * GB, gb = min(GB, G - g0);
    const bool tile = pt < gb * NPT;
    __syncthreads();                    // the scales are in; P is free
    load_p(g0, gb);
    for (int c = r; c < nch; c += C) {
      const int c0 = c * SC;
      copy_at(c, g0, gb, std::false_type{});
      cp_async_wait_all();
      if (s1) copy_at(c, g0, gb, std::true_type{});
      __syncthreads();
      if (tile) {
        float u[4][TS], v[4][TS], scl[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
        uv_tile<TS>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                    x1 + tg * AP * SCP + st * TS,
                    x2 + tg * AP * SCP + st * TS, A, AP, SCP, u, v);
#pragma unroll
        for (int h = 0; h < TS / 4; ++h) {
          const float4 f = ld4(sraw + c0 + st * TS + 4 * h);
#pragma unroll
          for (int s = 0; s < 4; ++s) scl[4 * h + s] = comp(f, s);
        }
        const int s0 = c0 + st * TS;
        float* o = out + (size_t)((g0 + tg) * A + ta) * S + s0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ta + i < A) {
            float* oi = o + (size_t)i * S;
#pragma unroll
            for (int h = 0; h < TS / 4; ++h) {
              float y[4];
#pragma unroll
              for (int s = 0; s < 4; ++s)
                y[s] = __fdiv_rn(__fmul_rn(u[i][4 * h + s], v[i][4 * h + s]),
                                 scl[4 * h + s]);
              if (width == 4 && s0 + 4 * h < S) {
                st4(oi + 4 * h, y[0], y[1], y[2], y[3]);
              } else if (width == 2 && s0 + 4 * h + 2 < S) {
                *reinterpret_cast<float2*>(oi + 4 * h) =
                    make_float2(y[0], y[1]);
                *reinterpret_cast<float2*>(oi + 4 * h + 2) =
                    make_float2(y[2], y[3]);
              } else {
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  if (s0 + 4 * h + s < S) oi[4 * h + s] = y[s];
              }
            }
          }
        }
      }
      __syncthreads();                  // the next chunk's copies may land
    }
  }

  // the block's sums: lanes by shuffles, the site warps in order
  if (tid < ((SC + 31) & ~31)) {
    float a0 = tid < SC ? racc0 : 0.f, a1 = tid < SC ? racc1 : 0.f;
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      red[2 * wid] = a0;
      red[2 * wid + 1] = a1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = 0.f, t1 = 0.f;
    for (int j = 0; j < (SC + 31) / 32; ++j) {
      t0 += red[2 * j];
      t1 += red[2 * j + 1];
    }
    red[8] = t0;
    red[9] = t1;
  }
  cluster.sync();                       // every rank's sums are staged
  if (r == 0 && tid == 0) {             // rank 0 adds them in rank order
    float t0 = 0.f, t1 = 0.f;
    for (int j = 0; j < C; ++j) {
      const float* o = cluster.map_shared_rank(red, j);
      t0 += o[8];
      t1 += o[9];
    }
    rootll[k] = t0;
    logscale[k] = t1;
  }
  cluster.sync();                       // no rank leaves while it is read
}

// Shared-memory layout of the backward's group form (floats; every region
// 16-byte aligned): the group's P_l, P_r as (GB, AP, AP) zero-padded
// blocks, reused after each round as its dP / dpi staging row; the
// group's pi; the chunk's x1, x2, gm (then du) and dv tiles of the
// group's planes, (GB*AP, SC) at pitch SC + 4; the dpi partials (NST x
// GB*AP).
struct BwdGroupLayout {
  int AP, GAP, tile, preg, pv, x1, dv, dpis, total;
  __host__ __device__ BwdGroupLayout(int GB, int A, int NST) {
    const int SCP = 4 * NST + 4, GBA = GB * A;
    AP = (A + 3) & ~3;
    GAP = GB * AP;
    tile = GAP * SCP;
    const int stage = (2 * GB * A * A + GBA + 3) & ~3;
    preg = 2 * GB * AP * AP > stage ? 2 * GB * AP * AP : stage;
    pv = preg;
    x1 = pv + ((GBA + 3) & ~3);         // then x2, gm a tile apart
    dv = x1 + 3 * tile;
    dpis = dv + tile;
    total = dpis + NST * GAP;
  }
};

// K9bs (Gather = false) and K9b (Gather = true) in block groups; K11a
// likewise.  grid (C, K) as wide_rank_bwd_kernel; threads (plane tile pt,
// site tile st), tid = pt NST + st, over the group's tiles; the
// one-group body's math and sum orders step for step (its comments say
// each step).  part (K, 4, G ceil(A / 4), S_pad), sscr (K, 5, S_pad).
template <bool Gather, int NST>
__global__ void __launch_bounds__(bwd_max_threads(NST))
    wide_rank_bwd_group_kernel(
        const float* __restrict__ m1g, const float* __restrict__ m2g,
        const float* __restrict__ leaves, const float* __restrict__ buf,
        const int* __restrict__ idx, const float* __restrict__ gmg,
        const float* __restrict__ gr, const float* __restrict__ gl,
        const float* __restrict__ Pl, const float* __restrict__ Pr,
        const float* __restrict__ pi, const float* __restrict__ w,
        float* __restrict__ dm1g, float* __restrict__ dm2g,
        float* __restrict__ dPl, float* __restrict__ dPr,
        float* __restrict__ dpi_part, float* __restrict__ dw_part,
        float* part, float* sscr, int K, int R, int N, int G, int A, int S,
        int GB) {
  constexpr int SC = 4 * NST, SCP = SC + 4, DPT = kGroupDpt;
  constexpr int PW = 32 / NST;          // plane tiles a warp (one group)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdGroupLayout L(GB, A, NST);
  const int AP = L.AP, GAP = L.GAP, NPT = AP / 4, GT = G * NPT;
  const int GA = G * A, AA = A * A;
  const int C = gridDim.x, r = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, NT = blockDim.x;
  float* pl = smem;
  float* pr = smem + GB * AP * AP;
  float* pv = smem + L.pv;
  float* x1 = smem + L.x1;
  float* x2 = x1 + L.tile;
  float* gd = x1 + 2 * L.tile;          // gm, then du
  float* dv = smem + L.dv;
  float* dpis = smem + L.dpis;
  const size_t slab = (size_t)GA * S;
  const int nch = (S + SC - 1) / SC, Sp = nch * SC;
  float* tp = part + (size_t)k * 4 * GT * Sp;   // (4, GT, Sp)
  float* ssc = sscr + (size_t)k * 5 * Sp;       // (5, Sp)

  for (int e = tid; e < (AP - A) * GB * SC; e += NT) {  // padded planes
    const int row = e / SC, s = e - row * SC;
    const int g = row / (AP - A), a = A + row % (AP - A);
    float* x = x1 + (g * AP + a) * SCP + s;
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
  const int tg = pt / NPT;              // the tile's block in its group
  const int ta = (pt - tg * NPT) * 4;   // its first plane within the block
  const int prow = tg * AP + ta;        // its first padded row
  const int NG = (G + GB - 1) / GB;

  // chunk c's x1, x2, gm of the group's planes by cp.async; zeros past S
  auto issue = [&](int c, int g0, int gb) {
    const int s = tid % SC, gs = c * SC + s;
    int g = 0, a = tid / SC;
    for (int p = a; p < gb * A; p += NT / SC) {
      while (a >= A) {                  // p = g A + a without a division
        a -= A;
        ++g;
      }
      float* d = x1 + (g * AP + a) * SCP + s;
      if (gs < S) {
        const size_t src = (size_t)(g0 * A + p) * S + gs;
        cp_async4(d, m1 + src);
        cp_async4(d + L.tile, m2 + src);
        cp_async4(d + 2 * L.tile, gm + src);
      } else {
        d[0] = d[L.tile] = d[2 * L.tile] = 0.f;
      }
      a += NT / SC;
    }
  };
  auto load_group = [&](int g0, int gb) {
    stage_p16(pl, pr, Pl + ((size_t)k * G + g0) * AA,
              Pr + ((size_t)k * G + g0) * AA, 0, gb, A, AP, tid, NT);
    for (int c = tid; c < gb * A; c += NT) pv[c] = pi[g0 * A + c];
  };

  // pass A: every (tile, site) partial of the one-group body's step (2)
  for (int q = 0; q < NG; ++q) {
    const int g0 = q * GB, gb = min(GB, G - g0);
    const bool tile = pt < gb * NPT;
    __syncthreads();                    // the former group's P is free
    load_group(g0, gb);
    for (int c = r; c < nch; c += C) {
      const int c0 = c * SC;
      issue(c, g0, gb);
      cp_async_wait_all();
      __syncthreads();
      if (tile) {
        float u[4][4], v[4][4];
        float praw[4], pneq[4], psite[4], pgsum[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          praw[s] = __int_as_float(0xff800000);  // -inf
          pneq[s] = psite[s] = pgsum[s] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
        }
        uv_tile<4>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                   x1 + tg * AP * SCP + st * 4, x2 + tg * AP * SCP + st * 4,
                   A, AP, SCP, u, v);
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
        float* o = tp + (size_t)(g0 * NPT + pt) * Sp + c0 + st * 4;
        const size_t qs = (size_t)GT * Sp;
        st4(o, praw[0], praw[1], praw[2], praw[3]);
        st4(o + qs, pneq[0], pneq[1], pneq[2], pneq[3]);
        st4(o + 2 * qs, psite[0], psite[1], psite[2], psite[3]);
        st4(o + 3 * qs, pgsum[0], pgsum[1], pgsum[2], pgsum[3]);
      }
      __syncthreads();                  // the next chunk's copies may land
    }
  }

  // each site of the block's chunks: the tiles combined in the one-group
  // body's order (a warp's PW tiles by its xor butterfly, the warps in
  // order), then its step (3)
  {
    const size_t qs = (size_t)GT * Sp;
    const int NWV = (GT + PW - 1) / PW;
    const int mine = (nch - r + C - 1) / C;
    for (int e = tid; e < mine * SC; e += NT) {
      const int s = (r + (e / SC) * C) * SC + e % SC;
      float raw = __int_as_float(0xff800000);
      for (int t = 0; t < GT; ++t) raw = fmaxf(raw, tp[(size_t)t * Sp + s]);
      float neq = 0.f, site = 0.f, gsum = 0.f;
      for (int wv = 0; wv < NWV; ++wv) {
        float mr[PW], mn[PW], ms[PW], mg[PW];
#pragma unroll
        for (int j = 0; j < PW; ++j) {
          const int t = wv * PW + j;
          const bool ok = t < GT;
          const float* o = tp + (size_t)(ok ? t : 0) * Sp + s;
          mr[j] = ok ? o[0] : __int_as_float(0xff800000);
          mn[j] = ok ? o[qs] : 0.f;
          ms[j] = ok ? o[2 * qs] : 0.f;
          mg[j] = ok ? o[3 * qs] : 0.f;
        }
#pragma unroll
        for (int d = 1; d < PW; d <<= 1)
#pragma unroll
          for (int j = 0; j < PW; j += 2 * d) {
            const float m = fmaxf(mr[j], mr[j + d]);
            mn[j] = (mr[j] == m ? mn[j] : 0.f) + (mr[j + d] == m ? mn[j + d]
                                                                : 0.f);
            mr[j] = m;
            ms[j] = ms[j] + ms[j + d];
            mg[j] = mg[j] + mg[j + d];
          }
        if (mr[0] == raw) neq += mn[0];
        site = site + ms[0];
        gsum = gsum + mg[0];
      }
      float inv = 0.f, dsite = 0.f, draw = 0.f;
      if (s < S) {                       // padded sites carry no cotangent
        const float scale = fmaxf(raw, FLT_MIN);
        const float ws = w[s];
        inv = 1.f / scale;
        dsite = (grk * ws) / site;
        const float dscale = (glk * ws) / scale - gsum * (inv * inv);
        // max(raw, tiny): full cotangent above the clamp, half at it
        draw = dscale *
               ((raw > FLT_MIN ? 1.f : 0.f) + (raw == FLT_MIN ? 0.5f : 0.f));
        dw_part[(size_t)k * S + s] = grk * logf(site) + glk * logf(scale);
      }
      ssc[s] = inv;
      ssc[Sp + s] = dsite;
      ssc[2 * Sp + s] = draw;
      ssc[3 * Sp + s] = 1.f / neq;       // eq / neq for eq in {0, 1}
      ssc[4 * Sp + s] = raw;
    }
  }

  // pass B: each group in rounds of DPT dP tiles a thread
  float* stage = smem;                  // P's region, after a round
  for (int q = 0; q < NG; ++q) {
    const int g0 = q * GB, gb = min(GB, G - g0);
    const bool tile = pt < gb * NPT;
    const int ntiles = 2 * gb * NPT * NPT, gAA = gb * AA;
    const int rounds = (ntiles + DPT * NT - 1) / (DPT * NT);
    for (int rho = 0; rho < rounds; ++rho) {
      const int base = rho * DPT * NT;
      __syncthreads();                  // the scalars are in; P is free
      load_group(g0, gb);
      float dpa[4] = {0.f, 0.f, 0.f, 0.f};
      float acc[DPT][16];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;
      for (int c = r; c < nch; c += C) {
        const int c0 = c * SC;
        issue(c, g0, gb);
        cp_async_wait_all();
        __syncthreads();
        // (2) u, v again; (4) du over the cotangent tile, dv, dpi
        if (tile) {
          float u[4][4], v[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) u[i][s] = v[i][s] = 0.f;
          uv_tile<4>(pl + tg * AP * AP + ta, pr + tg * AP * AP + ta,
                     x1 + tg * AP * SCP + st * 4,
                     x2 + tg * AP * SCP + st * 4, A, AP, SCP, u, v);
          const float* sc4 = ssc + c0 + st * 4;
          const float4 inv4 = ld4(sc4), ds4 = ld4(sc4 + Sp);
          const float4 dr4 = ld4(sc4 + 2 * Sp);
          const float4 rq4 = ld4(sc4 + 3 * Sp);
          const float4 rw4 = ld4(sc4 + 4 * Sp);
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
        // (5) dm1 = P_l du, dm2 = P_r dv (b ascending), the first round
        if (tile && rho == 0) {
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
                    d[i][s] =
                        __fmaf_rn(comp(pp[i], j), comp(yy[j], s), d[i][s]);
            }
            float* o = (side ? dm2 : dm1) + (size_t)((g0 + tg) * A + ta) * S +
                       c0 + st * 4;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (ta + i < A)
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  if (c0 + st * 4 + s < S) o[(size_t)i * S + s] = d[i][s];
          }
        }
        // the round's dP tiles += x du^T over the chunk's sites
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int t = base + tid + j * NT;
          if (t < ntiles) {
            const int side = t / (gb * NPT * NPT);
            const int rem = t - side * gb * NPT * NPT;
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

      // the round's dP (and the first round's dpi) row in P's region
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int t = base + tid + j * NT;
        if (t < ntiles) {
          const int side = t / (gb * NPT * NPT);
          const int rem = t - side * gb * NPT * NPT;
          const int g = rem / (NPT * NPT), ab = rem - g * NPT * NPT;
          const int ai = ab / NPT, bi = ab - ai * NPT;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int a = ai * 4 + i, b = bi * 4 + jj;
              if (a < A && b < A)
                stage[side * gAA + g * AA + a * A + b] = acc[j][i * 4 + jj];
            }
        }
      }
      if (rho == 0 && tile)
#pragma unroll
        for (int i = 0; i < 4; ++i) dpis[st * GAP + prow + i] = dpa[i];
      __syncthreads();
      if (rho == 0)
        for (int p = tid; p < gb * A; p += NT) {
          const int row = (p / A) * AP + p % A;
          float t = 0.f;
          for (int j = 0; j < NST; ++j) t += dpis[j * GAP + row];
          stage[2 * gAA + p] = t;
        }
      cluster.sync();                   // every rank's row is staged
      // rank r sums its slice of the row over the ranks in rank order,
      // the entries of this round only
      const int E = 2 * gAA + (rho == 0 ? gb * A : 0);
      const int lo = (int)((long long)E * r / C);
      const int hi = (int)((long long)E * (r + 1) / C);
      for (int e = lo + tid; e < hi; e += NT) {
        if (e < 2 * gAA) {
          const int side = e / gAA, rem = e - side * gAA;
          const int g = rem / AA, ab = rem - g * AA;
          const int a = ab / A, b = ab - a * A;
          const int t = (side * gb + g) * NPT * NPT + (a >> 2) * NPT + (b >> 2);
          if (t / (DPT * NT) != rho) continue;
        }
        float t = 0.f;
        for (int j = 0; j < C; ++j) t += cluster.map_shared_rank(stage, j)[e];
        if (e < gAA)
          dPl[((size_t)k * G + g0) * AA + e] = t;
        else if (e < 2 * gAA)
          dPr[((size_t)k * G + g0) * AA + e - gAA] = t;
        else
          dpi_part[(size_t)k * GA + g0 * A + e - 2 * gAA] = t;
      }
      cluster.sync();                   // no rank leaves while read
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool planes_ok(int G, int A) {
  return A >= 1 && A <= kMaxStates && G >= 1 && G <= kMaxBlocks;
}

// Launches kernel on the grid (cluster, K) in clusters of `cluster`
// blocks of `threads`, with smem bytes of dynamic shared memory.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), int cluster, int K,
                   int threads, size_t smem, cudaStream_t st,
                   Args... args) {
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int TS, int NST, int MINB = 2>
int run_fwd(const float* leaves, float* buf, const int* idx, const float* Pl,
            const float* Pr, const float* pi, const float* w, float* rootll,
            float* logscale, float* c1, float* c2, int K, int R, int N,
            int G, int A, int S, int outc, int cluster, int threads,
            cudaStream_t st) {
  const size_t smem =
      (size_t)FwdLayout(G, A, TS * NST, threads / 32).total * sizeof(float);
  return launch_cluster(wide_rank_fwd_kernel<TS, NST, MINB>, cluster, K,
                        threads,
                        smem, st, leaves, buf, idx, Pl, Pr, pi, w, rootll,
                        logscale, c1, c2, K, R, N, G, A, S, outc);
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
  return launch_cluster(wide_rank_bwd_kernel<Gather, DPT, NST>, cluster, K,
                        threads, smem, st, m1, m2, leaves, buf, idx, gm, gr,
                        gl, Pl, Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part,
                        dw_part, K, R, N, G, A, S);
}

// The plan (pruning/kernels.py::wide_fwd_plan): chunks of `sc` = 4 nst
// sites (tiles of 4 planes x 4 sites), `cluster` blocks a particle (1..8,
// at most its chunks), `threads` a block (a multiple of 32 and of sc
// covering the G ceil(A / 4) x nst tiles, at most 256).
int launch_fwd(const float* leaves, float* buf, const int* idx,
               const float* Pl, const float* Pr, const float* pi,
               const float* w, float* rootll, float* logscale, float* c1,
               float* c2, int K, int R, int N, int G, int A, int S, int outc,
               int sc, int cluster, int threads, void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (!planes_ok(G, A) || sc <= 0 || sc % 4) return (int)cudaErrorInvalidValue;
  const int npt = (A + 3) / 4, nst = sc / 4;
  const int nch = (S + sc - 1) / sc;
  if (cluster < 1 || cluster > kMaxCluster || cluster > nch ||
      threads % 32 || threads % sc || threads < G * npt * nst ||
      threads > kFwdMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHYLO_RUN_FWD(NST)                                                  \
  return run_fwd<4, NST>(leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, \
                         c1, c2, K, R, N, G, A, S, outc, cluster, threads,  \
                         st)
  switch (nst) {
    case 2: PHYLO_RUN_FWD(2);
    case 4: PHYLO_RUN_FWD(4);
    case 8: PHYLO_RUN_FWD(8);
    case 16: PHYLO_RUN_FWD(16);
  }
#undef PHYLO_RUN_FWD
  return (int)cudaErrorInvalidValue;
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

template <int NST>
int run_fwd_group(const float* leaves, float* buf, const int* idx,
                  const float* Pl, const float* Pr, const float* pi,
                  const float* w, float* rootll, float* logscale, float* c1,
                  float* c2, float* scr, int K, int R, int N, int G, int A,
                  int S, int outc, int cluster, int threads, int gb,
                  cudaStream_t st) {
  const size_t smem =
      (size_t)FwdGroupLayout(gb, A, 4 * NST, threads / 32).total *
      sizeof(float);
  return launch_cluster(wide_rank_fwd_group_kernel<NST>, cluster, K, threads,
                        smem, st, leaves, buf, idx, Pl, Pr, pi, w, rootll,
                        logscale, c1, c2, scr, K, R, N, G, A, S, outc, gb);
}

// K9f's group form (pruning/kernels.py::wide_fwd_plan with gb < G):
// chunks of `sc` = 16 or 32 sites, `cluster` blocks a particle, `threads`
// (a multiple of 32 and of sc covering the gb ceil(A / 4) x sc / 4 tiles
// of a group, at most 256), groups of `gb` blocks; scr (K, 2, S_pad).
int launch_fwd_group(const float* leaves, float* buf, const int* idx,
                     const float* Pl, const float* Pr, const float* pi,
                     const float* w, float* rootll, float* logscale,
                     float* c1, float* c2, float* scr, int K, int R, int N,
                     int G, int A, int S, int outc, int sc, int cluster,
                     int threads, int gb, void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (!planes_ok(G, A) || gb < 1 || gb > G || (sc != 16 && sc != 32))
    return (int)cudaErrorInvalidValue;
  const int npt = (A + 3) / 4, nst = sc / 4;
  const int nch = (S + sc - 1) / sc;
  if (cluster < 1 || cluster > kMaxCluster || cluster > nch ||
      threads % 32 || threads % sc || threads < gb * npt * nst ||
      threads > kFwdMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nst == 8)
    return run_fwd_group<8>(leaves, buf, idx, Pl, Pr, pi, w, rootll,
                            logscale, c1, c2, scr, K, R, N, G, A, S, outc,
                            cluster, threads, gb, st);
  return run_fwd_group<4>(leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale,
                          c1, c2, scr, K, R, N, G, A, S, outc, cluster,
                          threads, gb, st);
}

template <bool Gather, int NST>
int run_bwd_group(const float* m1, const float* m2, const float* leaves,
                  const float* buf, const int* idx, const float* gm,
                  const float* gr, const float* gl, const float* Pl,
                  const float* Pr, const float* pi, const float* w,
                  float* dm1, float* dm2, float* dPl, float* dPr,
                  float* dpi_part, float* dw_part, float* part, float* sscr,
                  int K, int R, int N, int G, int A, int S, int cluster,
                  int threads, int gb, cudaStream_t st) {
  const size_t smem = (size_t)BwdGroupLayout(gb, A, NST).total *
                      sizeof(float);
  return launch_cluster(wide_rank_bwd_group_kernel<Gather, NST>, cluster, K,
                        threads, smem, st, m1, m2, leaves, buf, idx, gm, gr,
                        gl, Pl, Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part,
                        dw_part, part, sscr, K, R, N, G, A, S, gb);
}

// The backward's group form (pruning/kernels.py::wide_bwd_plan with gb <
// G): chunks of `sc` = 16 or 32 sites, `cluster` blocks a particle,
// `threads` (a multiple of 32 covering a group's gb ceil(A / 4) x sc / 4
// tiles), groups of `gb` blocks, kGroupDpt dP tiles a thread a round;
// part (K, 4, G ceil(A / 4), S_pad), sscr (K, 5, S_pad).
template <bool Gather>
int launch_bwd_group(const float* m1, const float* m2, const float* leaves,
                     const float* buf, const int* idx, const float* gm,
                     const float* gr, const float* gl, const float* Pl,
                     const float* Pr, const float* pi, const float* w,
                     float* dm1, float* dm2, float* dPl, float* dPr,
                     float* dpi_part, float* dw_part, float* part,
                     float* sscr, int K, int R, int N, int G, int A, int S,
                     int sc, int cluster, int threads, int gb,
                     void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (!planes_ok(G, A) || gb < 1 || gb > G || (sc != 32 && sc != 16))
    return (int)cudaErrorInvalidValue;
  const int npt = (A + 3) / 4, nst = sc / 4;
  const int nch = (S + sc - 1) / sc;
  if (cluster < 1 || cluster > kMaxCluster || cluster > nch ||
      threads % 32 || threads < gb * npt * nst ||
      threads > bwd_max_threads(nst))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nst == 8)
    return run_bwd_group<Gather, 8>(m1, m2, leaves, buf, idx, gm, gr, gl,
                                    Pl, Pr, pi, w, dm1, dm2, dPl, dPr,
                                    dpi_part, dw_part, part, sscr, K, R, N,
                                    G, A, S, cluster, threads, gb, st);
  return run_bwd_group<Gather, 4>(m1, m2, leaves, buf, idx, gm, gr, gl, Pl,
                                  Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part,
                                  dw_part, part, sscr, K, R, N, G, A, S,
                                  cluster, threads, gb, st);
}

}  // namespace

extern "C" int launch_wide_rank(const float* leaves, float* buf,
                                const int* idx, const float* Pl,
                                const float* Pr, const float* pi,
                                const float* w, float* rootll,
                                float* logscale, float* c1, float* c2, int K,
                                int R, int N, int G, int A, int S, int outc,
                                int sc, int cluster, int threads,
                                void* stream) {
  return launch_fwd(leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1,
                    c2, K, R, N, G, A, S, outc, sc, cluster, threads,
                    stream);
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

extern "C" int launch_wide_rank_group(
    const float* leaves, float* buf, const int* idx, const float* Pl,
    const float* Pr, const float* pi, const float* w, float* rootll,
    float* logscale, float* c1, float* c2, float* scr, int K, int R, int N,
    int G, int A, int S, int outc, int sc, int cluster, int threads, int gb,
    void* stream) {
  return launch_fwd_group(leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale,
                          c1, c2, scr, K, R, N, G, A, S, outc, sc, cluster,
                          threads, gb, stream);
}

extern "C" int launch_wide_rank_bwd_saved_group(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, float* part, float* sscr, int K, int G,
    int A, int S, int sc, int cluster, int threads, int gb, void* stream) {
  return launch_bwd_group<false>(m1, m2, nullptr, nullptr, nullptr, gm, gr,
                                 gl, Pl, Pr, pi, w, dm1, dm2, dPl, dPr,
                                 dpi_part, dw_part, part, sscr, K, 0, 0, G,
                                 A, S, sc, cluster, threads, gb, stream);
}

extern "C" int launch_wide_rank_bwd_group(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, float* part, float* sscr,
    int K, int R, int N, int G, int A, int S, int sc, int cluster,
    int threads, int gb, void* stream) {
  return launch_bwd_group<true>(nullptr, nullptr, leaves, buf, idx, gm, gr,
                                gl, Pl, Pr, pi, w, dm1, dm2, dPl, dPr,
                                dpi_part, dw_part, part, sscr, K, R, N, G, A,
                                S, sc, cluster, threads, gb, stream);
}
