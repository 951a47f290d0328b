// Kernels K11b, K7 wide and K11c of phylo_tpu_torch: the VNCSMC
// pair-loglik forward and its two backwards, dense (up to 64 states:
// GTR+Gamma4 as 16 dense states, codons 61) or blocked (a rate mixture's
// G <= 32 per-category blocks of A_b <= 64 states: GTR+Gamma4 is G = 4
// blocks of 4, +I G = 5, protein+Gamma4 G = 4 blocks of 20, GY94+Gamma4
// G = 4 blocks of 61).
//
// The function, for M candidate merges of each of KC (particle, pair)
// rows that share their children m1, m2 (KC, G*A_b, S):
//
//     u = P_l[m]^T m1,  v = P_r[m]^T m2,  site = sum_b pi_b u_b v_b
//     ll[m, k] = sum_s w_s log site[m, k, s]
//
// with P (M, KC, A, A) dense, or (M, KC, G, A_b, A_b) blocked, where
// u_b runs only over the a of b's block (planes category-major, state
// g * A_b + a).  A dense P is the blocked form with G = 1.  Skipping the
// zero off-block terms changes no value: fma(x, 0, u) == u, so on a
// block-diagonal input the blocked chains equal the dense ones.
//
// K11b replaces phylo_tpu/pruning/kernels.py::fused_pair_loglik, both
// of its Pallas sites: _pair_ll_forward (body _kernel_ll, grid (K-tile,
// site-tile, M)) and _pair_ll_forward2 (body _kernel_ll_fwd2, M looped
// inside the program), which compute the same (M, KC) log-likelihoods.
// K7 wide replaces ::_pair_ll_bwd_pallas's body _kernel_ll_bwd above
// A = 8 dense states, and for every blocked input (twist_kernels.cu holds
// K7 for dense A <= 8): given g[m, k] = d loss / d ll[m, k], dm1, dm2
// (KC, G*A_b, S) summed over m and dP_l, dP_r in P's shape, summed over
// sites.  K11c replaces the same function's T-field body _kernel_ll_bwd2
// (PHYLO_TWIST_BWD_V2; twist_kernels.cu holds it at dense A <= 8): the
// same dm1, dm2, and dP through the bilinear form T[m, k, a, a'] =
// sum_s gsite m1[a] m2[a'] (gsite = g w / site): dP_l = (T P_r) pi and
// dP_r = (T^T P_l) pi, T only on the diagonal blocks of a blocked P (dP
// is returned only there).  The JAX package forms dP from T outside its
// kernel; here the kernel does, and returns dP as K7 wide does.  dpi and
// dw stay in the wrapper, as in the JAX package.  The JAX bodies unroll
// any A, and its twist enumerates a rate mixture's dense block-diagonal
// (G A_b)-state transitions; here a blocked input of any G <= 32 blocks
// runs in block groups (below).
//
// What bounds them on an H100.  Per (m, k, s) the forward does
// 2 A^2 / G FMAs (DS1 GTR+Gamma4 blocked: 128, dense 512; protein+Gamma4
// 3,200) against 2 G A_b message floats read once for all M; K7 about
// 6 A^2 / G.  At M = 10 both sit near or above the card's FP32 ridge
// (20 FLOP/B), so operations bound them, with bytes close behind for
// the blocked forward (DS1 rank 0, M = 10, S = 256: K11b blocked 0.131
// ms by operations, 0.127 by bytes; dense 0.461; K7 wide blocked at 896
// rows 0.030, dense 0.109).  All arithmetic is FP32 FMAs on the CUDA
// cores in a fixed order (no tensor cores, no TF32: ROADMAP's numerics
// rule, and a 4 x 4 block is far below an mma tile).  What held the
// first bodies back was shared memory: one broadcast load per FMA (K11b), two
// operands per FMA plus a global read-modify-write of every dP partial
// per (m, 32-site tile) and five barriers per (m, tile) (K7 wide and
// K11c); and the zero off-block terms, 3/4 of a GTR+Gamma4 twist's FMAs.
//
// Design.
// * K11b: one block per (row k, site tile); each thread owns SPT = 2
//   consecutive sites (1 above 32 padded planes) and holds their
//   message values of one block group in registers for all M, loaded as
//   one float2 per plane.  A block group is NG padded blocks of AB
//   padded states (both powers of two): all G blocks at once while they
//   fit 64 planes (DS1: 4 x 4, dense up to 64 states: one group),
//   else groups of 32 planes at two sites a thread (protein+Gamma4: 4
//   groups of one block of 32 padded states), or of one block of 64
//   (GY94+Gamma4).  On the H100 32-plane groups ran 1.6-1.8x quicker
//   than 64-plane groups at one site a thread (half the FMAs per P load
//   and per register of messages; PERF.md §6).
//   P_l[m, k], P_r[m, k] of the group come into shared memory by
//   cp.async, double-buffered across the (group, m) steps (the next step
//   lands while one computes), rows at pitch AB >= A_b; a thread reads a
//   row's four b-values with one float4 broadcast load, which feeds 4
//   SPT FMAs a side.  Each u_b, v_b is one FMA chain, a ascending from
//   the block's first plane (the first body's chains, so the dense form
//   gives its site values).  The group loop is outside the m loop: each
//   (m, site) sum runs on in registers within a group and in shared
//   memory across groups (each thread's own M x SPT slots, 10 KB at M =
//   10 and 128 threads), one chain in plane order, so a site's value is
//   the same chain as with all blocks in one group.  At S = 256 a block
//   of 128 threads (256 at one site a thread) covers the whole row, so P
//   is read once per (m, row).  After the last group each m's site sum
//   is a warp sum and a fixed-order sum of the warps' partials
//   (double-buffered by the parity of m: one barrier per step) into one
//   partial per (m, k, tile), which the wrapper sums with torch.sum (no
//   atomics).
//   Templated on (AB, NG, MULTI): the message registers are indexed at
//   compile time, the runtime G <= NG (a group's), A_b <= AB are
//   guarded, and up to 16 planes an EXACT instance folds the guards away
//   (1.4x at DS1; tools/torch_twist_forms.py).  MULTI (more than one
//   group) is its own instance, so one group runs the one-group code.
//   Against M (H100, S = 256, DS1 rank 0; tools/torch_twist_forms.py):
//   ~0.028 ms per m blocked and ~0.077 dense, the m loop at ~40% and
//   ~57% of the FP32 peak, plus 0.05-0.07 ms that does not grow with M.
// * K7 wide: one block per row k, M looped inside (_kernel_ll_bwd's
//   fori_loop), over site chunks of SC sites (the wrapper's plan: SC =
//   S = 256 at the training shape for up to 8 plane groups of 4).  The
//   chunk's m1, m2 sit in shared memory at pitch SC + 4 (16-byte aligned,
//   rows 4 banks apart).  Per m, three barriers: (A) a thread owns a
//   (4 planes x 4 sites) tile, computes u, v with float4 loads (a site
//   quad of m1 against a broadcast quad of P: 16 FMAs per two loads),
//   writes pi u, pi v and its 4-plane partial of site; (B) the same
//   thread sums the partials in plane order into gsite = g w / site (w in
//   registers, g[m, k] loaded one m ahead) and adds sum_b P[a, b] gsite
//   (pi v)_b onto its dm tile, which stays in registers across all M and
//   is written once per chunk; (C) the 2 G A_b^2 dP sums over the chunk:
//   a thread owns a (4 x 4) (a, b) tile of one side and block and
//   streams a slice of the sites as float4 quads; the KS threads of a
//   tile reduce with xor shuffles in a fixed order and one writes.  At
//   S <= SC every dP entry is written once per (m, row); above, each
//   further chunk adds its sum in chunk order (the block owns the row, so
//   nothing races).  P comes in by cp.async in both layouts (rows for u,
//   v; columns for dm), double-buffered across m.  A_b at run time, with
//   compile-time instances for A_b = 4 (DNA blocks) and 16 (dense
//   GTR+Gamma4), ~15% quicker.
// * Block groups in K7 wide and K11c.  The layout above holds every
//   plane of a row's chunk: at S = 256 it fits protein+Gamma4 (80
//   planes) only at SC = 96 (187,920 bytes: three chunks, one block an
//   SM) and +Gamma8 (160) at SC = 32, and not GY94+Gamma4, whose
//   double-buffered P in both layouts alone is 8 x 244 x 64 floats (500
//   KB).  So the plan (pruning/kernels.py::twist_bwd_group) keeps all G
//   blocks in one group while its chunk holds 128 sites (or all S), or
//   the grid has under two blocks an SM, and else takes GB = 1 block a
//   group, at up to 256 sites a chunk.  gsite
//   needs every group's planes before it exists, so it comes from a
//   first pass: per group, m1, m2 and P of the group are staged and u, v
//   computed, and each (m, site) sum runs on across groups in plane order
//   into M rows of shared memory (so gsite, and dm, are the bits of the
//   one-group form); a second pass per group stages m1, m2 and P again,
//   recomputes u, v (the same chains) and does (B) and (C) as above, its
//   dm tile across all M in registers and written once per (chunk,
//   group).  Keeping pi u, pi v of all planes instead (the other choice)
//   would need 2 G A_b (SC + 4) floats for the chunk, 73 KB for
//   GY94+Gamma4 at SC = 32 and 590 KB for 32 blocks of 64 planes: it
//   does not fit where groups are needed, and at SC = 256 it would leave
//   protein+Gamma4 no room.  The second pass costs u, v again (a third of
//   K7's FMAs) and P staged twice, yet on the H100 a block a group at SC
//   = 256 (112 KB: two blocks an SM) beat the one-group layout at SC = 96
//   by 9-10% at protein+Gamma4, and by 1.2-2x at 5 and 8 blocks of 20;
//   at SC = 128 (3 x 20) one group won by 13% (PERF.md §6).  One
//   group is the one-pass body unchanged.
// * K11c: K7 wide's body in its T-field form, dense (8 < A <= 64) and
//   blocked.  Phases A and B are K7 wide's; phase C sums the G NPG^2 (4 x
//   4) tiles of T over the chunk (half of K7 wide's 2 G NPG^2 dP tiles),
//   each block's diagonal block only, from the chunk's m1, m2 and gsite
//   in shared memory and stages T there; after a fourth barrier, phase D
//   forms each dP entry from T and the staged P (A_b FMAs, then pi_b)
//   and writes it once per (m, row), or adds it in chunk order above SC
//   sites.  Its block groups are K7 wide's.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxStates = 64;        // A of a dense P, A_b of a blocked one
constexpr int kFwdTile = 64;          // K11b: padded planes of one group
constexpr int kFwdGroup = 32;         // K11b: of a group among several
constexpr int kMaxG = 32;
constexpr int kFwdMaxThreads = 256;   // K11b
constexpr int kFwdMaxWarps = kFwdMaxThreads / 32;
constexpr int kBwdMaxThreads = 512;   // K7 wide
constexpr int kBwdMaxSC = 256;        // K7 wide: sites per chunk
constexpr int kBwdMaxKS = 32;         // K7 wide: threads per dP tile
constexpr int kSmemMax = 232448;      // a block's shared memory on an H100

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += x[j] * y[i] for a quad x of sites and a quad y of planes
__device__ __forceinline__ void fma_quad(float (&acc)[4][4], float4 x,
                                         float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(xs[j], ys[i], acc[i][j]);
  }
}

// ------------------------------------------------------------------ K11b
// P_l[m, k], P_r[m, k] (G blocks of Ab x Ab, row-major) into shared
// memory, block g's row a at (g * AB + a) * AB; padding stays zero.
template <int AB>
__device__ __forceinline__ void stage_fwd(float* dl, float* dr,
                                          const float* sl, const float* sr,
                                          int G, int Ab, bool vec) {
  if (vec) {                           // Ab % 4 == 0, 16-byte aligned
    const int q = Ab >> 2, n = G * Ab * q;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int ga = c / q, j = (c - ga * q) << 2;
      const int d = (ga + (ga / Ab) * (AB - Ab)) * AB + j;
      cp_async16(dl + d, sl + ga * Ab + j);
      cp_async16(dr + d, sr + ga * Ab + j);
    }
  } else {
    const int n = G * Ab * Ab;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int ga = c / Ab, b = c - ga * Ab;
      const int d = (ga + (ga / Ab) * (AB - Ab)) * AB + b;
      cp_async4(dl + d, sl + c);
      cp_async4(dr + d, sr + c);
    }
  }
  cp_async_commit();
}

// SPT sites s0.. of one plane row p, zero past S
template <int SPT>
__device__ __forceinline__ void load_sites(const float* __restrict__ p,
                                           int s0, int S, bool vec,
                                           float (&x)[SPT]) {
  if (vec && s0 + SPT <= S) {
    if constexpr (SPT == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + s0));
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else if constexpr (SPT == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p + s0));
      x[0] = t.x;
      x[1] = t.y;
    } else {
      x[0] = __ldg(p + s0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) x[j] = s0 + j < S ? __ldg(p + s0 + j) : 0.f;
  }
}

// grid (KC, T); part (M, KC, T).  EXACT: G == NG and Ab == AB, so that
// the guards fold away and the b0 loop unrolls at compile time.  MULTI:
// the blocks in groups of NG (G > NG), each (m, site) sum carried across
// groups in shared memory.
template <int AB, int NG, int SPT, bool EXACT, bool MULTI>
__global__ void __launch_bounds__(kFwdMaxThreads) pair_ll_fwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ part, int KC, int M, int G_, int Ab_, int S,
    bool vecP, bool vecM) {
  constexpr int PM = NG * AB * AB;     // one P of a group in shared memory
  constexpr int kUnrollB = EXACT ? AB / 4 : 1;
  extern __shared__ __align__(16) float smem[];
  const int G = EXACT ? NG : G_, Ab = EXACT ? AB : Ab_;
  const int GA = G * Ab, BB = GA * Ab;
  const int NGR = MULTI ? (G + NG - 1) / NG : 1;   // block groups
  float* pbuf = smem;                  // [buffer][side][PM]
  float* pv = pbuf + 4 * PM;           // pi (G * Ab planes)
  float* red = pv + (MULTI ? (GA + 3) & ~3 : NG * AB);  // [parity][warp]
  float* acc = red + 2 * kFwdMaxWarps; // MULTI: [m][j][thread] site sums
  const int k = blockIdx.x, tile = blockIdx.y, T = gridDim.y;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = (tile * nthr + threadIdx.x) * SPT;

  for (int c = threadIdx.x; c < 4 * PM; c += nthr) pbuf[c] = 0.f;
  for (int c = threadIdx.x; c < GA; c += nthr) pv[c] = pi[c];
  float ws[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) ws[j] = s0 + j < S ? __ldg(w + s0 + j) : 0.f;
  __syncthreads();                     // the zero fill before the copies
  stage_fwd<AB>(pbuf, pbuf + PM, Pl + (size_t)k * BB, Pr + (size_t)k * BB,
                MULTI ? min(G, NG) : G, Ab, vecP);

  int step = 0;                        // (group, m): its P in buffer step & 1
  for (int gr = 0; gr < NGR; ++gr) {
    const int g0 = gr * NG, Gc = MULTI ? min(NG, G - g0) : G;
    const bool last = !MULTI || gr + 1 == NGR;
    const float* pvg = pv + g0 * Ab;
    float x1[NG][AB][SPT], x2[NG][AB][SPT];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int a = 0; a < AB; ++a) {
        if (g < Gc && a < Ab) {
          const size_t off = ((size_t)k * GA + (g0 + g) * Ab + a) * S;
          load_sites<SPT>(m1g + off, s0, S, vecM, x1[g][a]);
          load_sites<SPT>(m2g + off, s0, S, vecM, x2[g][a]);
        } else {
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            x1[g][a][j] = 0.f;
            x2[g][a][j] = 0.f;
          }
        }
      }
    }

    for (int m = 0; m < M; ++m, ++step) {
      cp_async_wait_all();
      __syncthreads();                   // P(step) landed; step - 1 is done
      if (m + 1 < M) {                   // into the buffer step - 1 read
        const size_t row = (size_t)(m + 1) * KC + k;
        float* d = pbuf + 2 * ((step + 1) & 1) * PM;
        stage_fwd<AB>(d, d + PM, Pl + row * BB + (size_t)g0 * Ab * Ab,
                      Pr + row * BB + (size_t)g0 * Ab * Ab, Gc, Ab, vecP);
      } else if (MULTI && gr + 1 < NGR) {  // the next group's P(0)
        const size_t off = (size_t)k * BB + (size_t)(g0 + NG) * Ab * Ab;
        float* d = pbuf + 2 * ((step + 1) & 1) * PM;
        stage_fwd<AB>(d, d + PM, Pl + off, Pr + off, min(NG, G - g0 - NG),
                      Ab, vecP);
      }
      if (last && m > 0 && threadIdx.x == 0) {
        const float* r = red + ((m - 1) & 1) * kFwdMaxWarps;
        float t = 0.f;
        for (int i = 0; i < nwarps; ++i) t += r[i];
        part[((size_t)(m - 1) * KC + k) * T + tile] = t;
      }
      const float* pl = pbuf + 2 * (step & 1) * PM;
      const float* pr = pl + PM;
      float site[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        site[j] = MULTI && gr > 0 ? acc[(m * SPT + j) * nthr + threadIdx.x]
                                  : 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g < Gc) {
#pragma unroll kUnrollB
          for (int b0 = 0; b0 < AB; b0 += 4) {
            if (b0 < Ab) {
              float u[4][SPT], v[4][SPT];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < SPT; ++j) {
                  u[i][j] = 0.f;
                  v[i][j] = 0.f;
                }
              }
              // u_b, v_b for b = b0..b0+3: one chain each, a ascending
#pragma unroll
              for (int a = 0; a < AB; ++a) {
                if (a < Ab) {
                  const float4 ql4 = lds4(pl + (g * AB + a) * AB + b0);
                  const float4 qr4 = lds4(pr + (g * AB + a) * AB + b0);
                  const float ql[4] = {ql4.x, ql4.y, ql4.z, ql4.w};
                  const float qr[4] = {qr4.x, qr4.y, qr4.z, qr4.w};
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int j = 0; j < SPT; ++j) {
                      u[i][j] = __fmaf_rn(x1[g][a][j], ql[i], u[i][j]);
                      v[i][j] = __fmaf_rn(x2[g][a][j], qr[i], v[i][j]);
                    }
                  }
                }
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (b0 + i < Ab) {
                  const float p = pvg[g * Ab + b0 + i];
#pragma unroll
                  for (int j = 0; j < SPT; ++j)
                    site[j] =
                        __fmaf_rn(__fmul_rn(u[i][j], v[i][j]), p, site[j]);
                }
              }
            }
          }
        }
      }
      if (!last) {                       // the chain goes on in the next group
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          acc[(m * SPT + j) * nthr + threadIdx.x] = site[j];
        continue;
      }
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        if (s0 + j < S) x += logf(site[j]) * ws[j];
      x = warp_sum(x);
      if (lane == 0) red[(m & 1) * kFwdMaxWarps + warp] = x;
    }
  }
  __syncthreads();
  if (M > 0 && threadIdx.x == 0) {
    const float* r = red + ((M - 1) & 1) * kFwdMaxWarps;
    float t = 0.f;
    for (int i = 0; i < nwarps; ++i) t += r[i];
    part[((size_t)(M - 1) * KC + k) * T + tile] = t;
  }
}

// -------------------------------------------------------------- K7 wide
// P_l[m, k], P_r[m, k] into shared memory in both layouts: ps row
// (g * Ab + a) holds P[g][a][:], pt row (g * Ab + b) holds P[g][:][b],
// at pitch ABP (padding stays zero).  d: [ps_l, ps_r, pt_l, pt_r][PM].
__device__ __forceinline__ void stage_bwd(float* d, const float* sl,
                                          const float* sr, int G, int Ab,
                                          int ABP, int PM) {
  const int n = G * Ab * Ab;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int ga = c / Ab, b = c - ga * Ab;   // ga = g * Ab + a
    const int a = ga - (ga / Ab) * Ab;
    const int ds = ga * ABP + b, dt = (ga - a + b) * ABP + a;
    cp_async4(d + ds, sl + c);
    cp_async4(d + PM + ds, sr + c);
    cp_async4(d + 2 * PM + dt, sl + c);
    cp_async4(d + 3 * PM + dt, sr + c);
  }
  cp_async_commit();
}

// The chunk's rows of m1, m2 (GAc planes from m1, m2) at sites s0 + [0,
// SC) into x1, x2 at pitch SCP, zero past S.
__device__ __forceinline__ void load_chunk(float* x1, float* x2,
                                           const float* __restrict__ m1,
                                           const float* __restrict__ m2,
                                           int GAc, int SG, int SCP, int S,
                                           int s0, bool vecM) {
  for (int e = threadIdx.x; e < GAc * SG; e += blockDim.x) {
    const int p = e / SG, j = (e - p * SG) * 4, s = s0 + j;
    const float* r1 = m1 + (size_t)p * S + s;
    const float* r2 = m2 + (size_t)p * S + s;
    float4 a4, b4;
    if (vecM && s < S) {
      a4 = __ldg(reinterpret_cast<const float4*>(r1));
      b4 = __ldg(reinterpret_cast<const float4*>(r2));
    } else {
      a4 = make_float4(s < S ? r1[0] : 0.f, s + 1 < S ? r1[1] : 0.f,
                       s + 2 < S ? r1[2] : 0.f, s + 3 < S ? r1[3] : 0.f);
      b4 = make_float4(s < S ? r2[0] : 0.f, s + 1 < S ? r2[1] : 0.f,
                       s + 2 < S ? r2[2] : 0.f, s + 3 < S ? r2[3] : 0.f);
    }
    *reinterpret_cast<float4*>(x1 + p * SCP + j) = a4;
    *reinterpret_cast<float4*>(x2 + p * SCP + j) = b4;
  }
}

// (A) u, v of planes g Ab + c0 + i at sites js + j: one FMA chain each,
// a ascending
__device__ __forceinline__ void uv_tile(float (&u)[4][4], float (&v)[4][4],
                                        const float* x1, const float* x2,
                                        const float* psl, const float* psr,
                                        int g, int c0, int js, int Ab,
                                        int SCP, int ABP) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[i][j] = 0.f;
      v[i][j] = 0.f;
    }
  }
#pragma unroll 4
  for (int a = 0; a < Ab; ++a) {
    const int r = g * Ab + a;
    fma_quad(u, lds4(x1 + r * SCP + js), lds4(psl + r * ABP + c0));
    fma_quad(v, lds4(x2 + r * SCP + js), lds4(psr + r * ABP + c0));
  }
}

// (A) the tile's pi u, pi v into pus, pvs (STORE) and its 4-plane partial
// of site into row q of sp (PART)
template <bool PART, bool STORE>
__device__ __forceinline__ void uv_out(const float (&u)[4][4],
                                       const float (&v)[4][4],
                                       const float* pis, float* pus,
                                       float* pvs, float* sp, int q, int g,
                                       int c0, int js, int Ab, int SCP) {
  float part4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c0 + i < Ab) {
      const int r = g * Ab + c0 + i;
      const float p = pis[r];
      if constexpr (PART) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part4[j] = __fmaf_rn(__fmul_rn(u[i][j], v[i][j]), p, part4[j]);
      }
      if constexpr (STORE) {
        sts4(pvs + r * SCP + js, v[i][0] * p, v[i][1] * p, v[i][2] * p,
             v[i][3] * p);
        sts4(pus + r * SCP + js, u[i][0] * p, u[i][1] * p, u[i][2] * p,
             u[i][3] * p);
      }
    }
  }
  if constexpr (PART)
    sts4(sp + q * SCP + js, part4[0], part4[1], part4[2], part4[3]);
}

// (B) dm1[a] += sum_b P_l[a, b] du_b with du = gsite (pi v), dm2 with P_r
// and dv = gsite (pi u), for a = c0 + i
__device__ __forceinline__ void dm_tile(float (&d1)[4][4], float (&d2)[4][4],
                                        const float (&gsj)[4],
                                        const float* pvs, const float* pus,
                                        const float* ptl, const float* ptr_,
                                        int g, int c0, int js, int Ab,
                                        int SCP, int ABP) {
#pragma unroll 4
  for (int b = 0; b < Ab; ++b) {
    const int r = g * Ab + b;
    const float4 e = lds4(pvs + r * SCP + js);
    const float4 f = lds4(pus + r * SCP + js);
    const float4 du = make_float4(gsj[0] * e.x, gsj[1] * e.y, gsj[2] * e.z,
                                  gsj[3] * e.w);
    const float4 dv = make_float4(gsj[0] * f.x, gsj[1] * f.y, gsj[2] * f.z,
                                  gsj[3] * f.w);
    fma_quad(d1, du, lds4(ptl + r * ABP + c0));
    fma_quad(d2, dv, lds4(ptr_ + r * ABP + c0));
  }
}

// (C) dP_l[a, b] = sum_s m1[a] du_b, dP_r[a, b] = sum_s m2[a] dv_b over
// the chunk for Gc blocks (dPl, dPr: the row's first block of them), one
// (4 x 4) tile per KS threads, added to what is there when `add`; TF: T[a,
// a'] = sum_s m1[a] (gsite m2[a']) of each block into tsm instead
template <bool TF>
__device__ __forceinline__ void dp_tiles(const float* x1, const float* x2,
                                         const float* pus, const float* pvs,
                                         const float* gs, float* tsm,
                                         float* dPl, float* dPr, int Gc,
                                         int Ab, int NPG, int ABP, int SC,
                                         int SCP, int KS, bool add) {
  const int t = threadIdx.x;
  const int TC = (TF ? 1 : 2) * Gc * NPG * NPG;
  const int kl = t & (KS - 1), tstride = blockDim.x / KS;
  for (int base = 0; base < TC; base += tstride) {
    const int tile = base + t / KS;
    const bool live = tile < TC;
    int r0 = tile;
    const int tb = r0 % NPG;
    r0 /= NPG;
    const int ta = r0 % NPG;
    r0 /= NPG;
    const int tg = r0 % Gc, side = r0 / Gc;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const int na = min(4, Ab - 4 * ta), nb = min(4, Ab - 4 * tb);
    if (live) {
      const float* X = (side ? x2 : x1) + (tg * Ab + 4 * ta) * SCP;
      const float* D = (TF ? x2 : side ? pus : pvs) +
                       (tg * Ab + 4 * tb) * SCP;
      for (int j = 4 * kl; j < SC; j += 4 * KS) {
        const float4 gq = lds4(gs + j);
        float dd[4][4];
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          const float4 e = jb < nb ? lds4(D + jb * SCP + j)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          dd[jb][0] = gq.x * e.x;
          dd[jb][1] = gq.y * e.y;
          dd[jb][2] = gq.z * e.z;
          dd[jb][3] = gq.w * e.w;
        }
#pragma unroll
        for (int ia = 0; ia < 4; ++ia) {
          if (ia < na) {
            const float4 x4 = lds4(X + ia * SCP + j);
            const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[ia][jb] = __fmaf_rn(xs[jj], dd[jb][jj], acc[ia][jb]);
            }
          }
        }
      }
    }
    for (int o = KS >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
      }
    }
    if (TF && live && kl == 0) {
#pragma unroll
      for (int ia = 0; ia < 4; ++ia) {
#pragma unroll
        for (int jb = 0; jb < 4; ++jb)
          if (ia < na && jb < nb)
            tsm[(tg * Ab + 4 * ta + ia) * ABP + 4 * tb + jb] = acc[ia][jb];
      }
    } else if (live && kl == 0) {
      float* out = (side ? dPr : dPl) + (size_t)tg * Ab * Ab +
                   (4 * ta) * Ab + 4 * tb;
#pragma unroll
      for (int ia = 0; ia < 4; ++ia) {
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (ia < na && jb < nb) {
            float* o = out + ia * Ab + jb;
            *o = add ? *o + acc[ia][jb] : acc[ia][jb];
          }
        }
      }
    }
  }
}

// (D) dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b], dP_r[a', b] = pi_b
// sum_a T[a, a'] P_l[a, b] within each of the BBc / Ab^2 blocks: chains
// over a' (a) ascending; added to what is there when `add`
__device__ __forceinline__ void dp_from_t(const float* tsm, const float* psl,
                                          const float* psr, const float* pis,
                                          float* dPl, float* dPr, int BBc,
                                          int Ab, int ABP, bool add) {
  for (int e = threadIdx.x; e < 2 * BBc; e += blockDim.x) {
    const int side = e >= BBc, c = side ? e - BBc : e;
    const int ga = c / Ab, b = c - ga * Ab;
    const int a = ga - (ga / Ab) * Ab, r0 = ga - a;  // r0: the block's row 0
    float x;
    if (side) {                        // a is a'
      x = __fmul_rn(tsm[r0 * ABP + a], psl[r0 * ABP + b]);
      for (int i = 1; i < Ab; ++i)
        x = __fmaf_rn(tsm[(r0 + i) * ABP + a], psl[(r0 + i) * ABP + b], x);
    } else {
      x = __fmul_rn(tsm[ga * ABP], psr[r0 * ABP + b]);
      for (int i = 1; i < Ab; ++i)
        x = __fmaf_rn(tsm[ga * ABP + i], psr[(r0 + i) * ABP + b], x);
    }
    x = __fmul_rn(x, pis[r0 + b]);
    float* o = (side ? dPr : dPl) + c;
    *o = add ? *o + x : x;
  }
}

// the dm tile of planes g Ab + c0 + i at sites s0 + js + j
__device__ __forceinline__ void store_dm(float* dm1, float* dm2,
                                         const float (&d1)[4][4],
                                         const float (&d2)[4][4], int g,
                                         int c0, int js, int Ab, int S,
                                         int s0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c0 + i < Ab) {
      const size_t r = (size_t)(g * Ab + c0 + i) * S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + js + j;
        if (s < S) {
          dm1[r + s] = d1[i][j];
          dm2[r + s] = d2[i][j];
        }
      }
    }
  }
}

// threads a dP (or T) tile: the most, up to kBwdMaxKS, that leave each of
// the TC tiles its threads in one pass
__device__ __forceinline__ int tile_threads(int TC) {
  int KS = 1;
  while (KS < kBwdMaxKS && 2 * KS * TC <= (int)blockDim.x) KS *= 2;
  return KS;
}

#define PHYLO_BWD_ARGS                                                     \
  const float *__restrict__ m1g, const float *__restrict__ m2g,            \
      const float *__restrict__ Pl, const float *__restrict__ Pr,          \
      const float *__restrict__ pi, const float *__restrict__ w,           \
      const float *__restrict__ gg, float *__restrict__ dm1g,              \
      float *__restrict__ dm2g, float *__restrict__ dPl,                   \
      float *__restrict__ dPr, int KC, int M, int G, int Ab_, int S,       \
      int SC, int GB, bool vecM
#define PHYLO_BWD_CALL                                                     \
  m1g, m2g, Pl, Pr, pi, w, gg, dm1g, dm2g, dPl, dPr, KC, M, G, Ab_, S, SC, \
      GB, vecM

// grid (KC,), blockDim.x >= NGT * SC / 4; dPl, dPr (M, KC, G, Ab, Ab).
// All G blocks in one group (GB = G).  FIXED_AB: Ab as a compile-time
// constant (4: DNA blocks; 16: dense GTR+Gamma4), or 0 for any Ab at run
// time.  TF: the T-field form (K11c), which also stages T (G Ab x ABP,
// the diagonal blocks) after pi.
template <int FIXED_AB, bool TF>
__device__ __forceinline__ void bwd_wide_body(PHYLO_BWD_ARGS) {
  extern __shared__ __align__(16) float smem[];
  const int Ab = FIXED_AB ? FIXED_AB : Ab_;
  const int GA = G * Ab, BB = GA * Ab;
  const int NPG = (Ab + 3) >> 2, NGT = G * NPG, ABP = NPG * 4;
  const int SCP = SC + 4, SG = SC >> 2, PM = GA * ABP;
  float* x1 = smem;                    // the chunk's m1 (GA x SC)
  float* x2 = x1 + GA * SCP;
  float* pvs = x2 + GA * SCP;          // pi_b v_b
  float* pus = pvs + GA * SCP;         // pi_b u_b
  float* sp = pus + GA * SCP;          // site partials of the NGT groups
  float* gs = sp + NGT * SCP;          // gsite = g w / site
  float* pb = gs + SCP;                // [buffer][4][PM]
  float* pis = pb + 8 * PM;            // pi
  float* tsm = pis + ((GA + 3) & ~3);  // K11c: the chunk's T of one m
  const int k = blockIdx.x, t = threadIdx.x, nthr = blockDim.x;
  // phases A and B: the (4 planes x 4 sites) tile (q, sg) of thread t
  const bool item = t < NGT * SG;
  const int q = t / SG, sg = t - q * SG, js = 4 * sg;
  const int g = q / NPG, c0 = (q - g * NPG) * 4;
  // phase C: (side, block, a-group, b-group) tiles, KS threads each;
  // K11c: (block, a-group, a'-group) tiles of T
  const int KS = tile_threads((TF ? 1 : 2) * G * NPG * NPG);
  const size_t slab = (size_t)GA * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;

  for (int c = t; c < 8 * PM; c += nthr) pb[c] = 0.f;
  for (int c = t; c < GA; c += nthr) pis[c] = pi[c];

  for (int s0 = 0; s0 < S; s0 += SC) {
    __syncthreads();                   // the last chunk's readers are done
    load_chunk(x1, x2, m1, m2, GA, SG, SCP, S, s0, vecM);
    if (M > 0)
      stage_bwd(pb, Pl + (size_t)k * BB, Pr + (size_t)k * BB, G, Ab, ABP, PM);
    float d1[4][4], d2[4][4];          // dm tiles, across all M
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d1[i][j] = 0.f;
        d2[i][j] = 0.f;
      }
    }
    // the thread's site weights, and g[m, k] one m ahead: no global load
    // waits on the barriers' path
    float wj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + js + j;
      wj[j] = item && s < S ? __ldg(w + s) : 0.f;
    }
    float g_next = item && M > 0 ? __ldg(gg + k) : 0.f;

    for (int m = 0; m < M; ++m) {
      const size_t row = (size_t)m * KC + k;
      cp_async_wait_all();
      __syncthreads();                 // (1) P(m) and the chunk landed
      if (m + 1 < M)
        stage_bwd(pb + ((m + 1) & 1) * 4 * PM, Pl + (row + KC) * BB,
                  Pr + (row + KC) * BB, G, Ab, ABP, PM);
      const float* psl = pb + (m & 1) * 4 * PM;
      const float* psr = psl + PM;
      const float* ptl = psr + PM;
      const float* ptr_ = ptl + PM;

      if (item) {                      // (A)
        float u[4][4], v[4][4];
        uv_tile(u, v, x1, x2, psl, psr, g, c0, js, Ab, SCP, ABP);
        uv_out<true, true>(u, v, pis, pus, pvs, sp, q, g, c0, js, Ab, SCP);
      }
      __syncthreads();                 // (2)

      // (B) gsite from the partials in plane order, then the dm tile
      const float gm = g_next;
      if (item && m + 1 < M) g_next = __ldg(gg + row + KC);
      if (item) {
        float site[4] = {0.f, 0.f, 0.f, 0.f};
        for (int qq = 0; qq < NGT; ++qq) {
          const float4 e = lds4(sp + qq * SCP + js);
          site[0] += e.x;
          site[1] += e.y;
          site[2] += e.z;
          site[3] += e.w;
        }
        float gsj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // padded sites have weight 0: gsite 0, they add nothing
          gsj[j] = s0 + js + j < S ? (gm * wj[j]) / site[j] : 0.f;
        }
        if (q == 0) sts4(gs + js, gsj[0], gsj[1], gsj[2], gsj[3]);
        dm_tile(d1, d2, gsj, pvs, pus, ptl, ptr_, g, c0, js, Ab, SCP, ABP);
      }
      __syncthreads();                 // (3) gsite visible

      dp_tiles<TF>(x1, x2, pus, pvs, gs, tsm, dPl + row * BB,
                   dPr + row * BB, G, Ab, NPG, ABP, SC, SCP, KS, s0 > 0);
      if constexpr (TF) {
        __syncthreads();               // (4) T staged
        dp_from_t(tsm, psl, psr, pis, dPl + row * BB, dPr + row * BB, BB,
                  Ab, ABP, s0 > 0);
      }
    }
    if (item) store_dm(dm1, dm2, d1, d2, g, c0, js, Ab, S, s0);
  }
}

// The same outputs for G blocks in groups of GB < G (any Ab at run time;
// TF: the T-field form).  Per chunk, pass 1 runs each group's u, v and
// carries each (m, site) sum across the groups, in plane order, in M rows
// of shared memory, which then become gsite; pass 2 runs each group's u,
// v again, its dm tile across all M and its dP (or T and dP).
template <bool TF>
__device__ __forceinline__ void bwd_wide_groups(PHYLO_BWD_ARGS) {
  extern __shared__ __align__(16) float smem[];
  const int Ab = Ab_;
  const int GA = G * Ab, BB = GA * Ab;
  const int NPG = (Ab + 3) >> 2, ABP = NPG * 4;
  const int GAg = GB * Ab, NGR = (G + GB - 1) / GB;
  const int SCP = SC + 4, SG = SC >> 2, PM = GAg * ABP;
  float* x1 = smem;                    // the chunk's m1 of a group
  float* x2 = x1 + GAg * SCP;
  float* pvs = x2 + GAg * SCP;         // pi_b v_b
  float* pus = pvs + GAg * SCP;        // pi_b u_b
  float* sp = pus + GAg * SCP;         // site partials of a group's tiles
  float* gs = sp + GB * NPG * SCP;     // [m]: site sums, then gsite
  float* pb = gs + M * SCP;            // [buffer][4][PM]
  float* pis = pb + 8 * PM;            // pi, every plane
  float* tsm = pis + ((GA + 3) & ~3);  // K11c: a group's T of one m
  const int k = blockIdx.x, t = threadIdx.x, nthr = blockDim.x;
  const int q = t / SG, sg = t - q * SG, js = 4 * sg;
  const int g = q / NPG, c0 = (q - g * NPG) * 4;
  const size_t slab = (size_t)GA * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;

  for (int c = t; c < 8 * PM; c += nthr) pb[c] = 0.f;
  for (int c = t; c < GA; c += nthr) pis[c] = pi[c];

  for (int s0 = 0; s0 < S; s0 += SC) {
    for (int pass = 0; pass < 2; ++pass) {
      for (int gr = 0; gr < NGR; ++gr) {
        const int g0 = gr * GB, Gc = min(GB, G - g0);
        const bool item = t < Gc * NPG * SG;
        const size_t poff = (size_t)g0 * Ab * Ab;  // in a row of P
        const float* pig = pis + g0 * Ab;
        const int KS = tile_threads((TF ? 1 : 2) * Gc * NPG * NPG);
        __syncthreads();               // the last group's readers are done
        load_chunk(x1, x2, m1 + (size_t)g0 * Ab * S,
                   m2 + (size_t)g0 * Ab * S, Gc * Ab, SG, SCP, S, s0, vecM);
        if (M > 0)
          stage_bwd(pb, Pl + (size_t)k * BB + poff,
                    Pr + (size_t)k * BB + poff, Gc, Ab, ABP, PM);
        float d1[4][4], d2[4][4];      // pass 2: dm tiles, across all M
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d1[i][j] = 0.f;
            d2[i][j] = 0.f;
          }
        }
        for (int m = 0; m < M; ++m) {
          const size_t row = (size_t)m * KC + k;
          cp_async_wait_all();
          __syncthreads();             // (1) P(m) and the chunk landed
          if (m + 1 < M)
            stage_bwd(pb + ((m + 1) & 1) * 4 * PM,
                      Pl + (row + KC) * BB + poff,
                      Pr + (row + KC) * BB + poff, Gc, Ab, ABP, PM);
          const float* psl = pb + (m & 1) * 4 * PM;
          const float* psr = psl + PM;
          const float* ptl = psr + PM;
          const float* ptr_ = ptl + PM;
          float* gsm = gs + m * SCP;
          if (pass == 0) {
            if (item) {
              float u[4][4], v[4][4];
              uv_tile(u, v, x1, x2, psl, psr, g, c0, js, Ab, SCP, ABP);
              uv_out<true, false>(u, v, pig, pus, pvs, sp, q, g, c0, js, Ab,
                                  SCP);
            }
            __syncthreads();           // (2)
            if (t < SG) {              // the site chain goes on, plane order
              float4 r = gr ? lds4(gsm + js)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
              for (int qq = 0; qq < Gc * NPG; ++qq) {
                const float4 e = lds4(sp + qq * SCP + js);
                r.x += e.x;
                r.y += e.y;
                r.z += e.z;
                r.w += e.w;
              }
              sts4(gsm + js, r.x, r.y, r.z, r.w);
            }
            continue;
          }
          if (item) {
            float u[4][4], v[4][4];
            uv_tile(u, v, x1, x2, psl, psr, g, c0, js, Ab, SCP, ABP);
            uv_out<false, true>(u, v, pig, pus, pvs, sp, q, g, c0, js, Ab,
                                SCP);
          }
          __syncthreads();             // (2)
          if (item) {
            const float4 e = lds4(gsm + js);
            const float gsj[4] = {e.x, e.y, e.z, e.w};
            dm_tile(d1, d2, gsj, pvs, pus, ptl, ptr_, g, c0, js, Ab, SCP,
                    ABP);
          }
          dp_tiles<TF>(x1, x2, pus, pvs, gsm, tsm, dPl + row * BB + poff,
                       dPr + row * BB + poff, Gc, Ab, NPG, ABP, SC, SCP, KS,
                       s0 > 0);
          if constexpr (TF) {
            __syncthreads();           // (3) T staged
            dp_from_t(tsm, psl, psr, pig, dPl + row * BB + poff,
                      dPr + row * BB + poff, Gc * Ab * Ab, Ab, ABP, s0 > 0);
          }
        }
        if (pass == 1 && item)
          store_dm(dm1 + (size_t)g0 * Ab * S, dm2 + (size_t)g0 * Ab * S, d1,
                   d2, g, c0, js, Ab, S, s0);
      }
      if (pass == 0) {
        __syncthreads();               // every group's site sums landed
        // gsite = g w / site; padded sites have weight 0: gsite 0
        for (int e = t; e < M * SG; e += nthr) {
          const int m = e / SG, j4 = (e - m * SG) * 4;
          const float gm = __ldg(gg + (size_t)m * KC + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + j4 + j;
            float* x = gs + m * SCP + j4 + j;
            *x = s < S ? (gm * __ldg(w + s)) / *x : 0.f;
          }
        }
      }
    }
  }
}

// K7 wide
template <int FIXED_AB>
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_wide_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_body<FIXED_AB, false>(PHYLO_BWD_CALL);
}

// K11c above 8 states and blocked: K7 wide's body in its T-field form
template <int FIXED_AB>
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_t_wide_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_body<FIXED_AB, true>(PHYLO_BWD_CALL);
}

// K7 wide over block groups
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_wide_groups_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_groups<false>(PHYLO_BWD_CALL);
}

// K11c over block groups
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_t_groups_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_groups<true>(PHYLO_BWD_CALL);
}

// ----------------------------------------------------------------- host
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<std::uintptr_t>(p) % n == 0;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// K11b's sites a thread for AB * NG padded planes (the message takes
// 2 AB NG SPT registers)
constexpr int fwd_spt(int planes) {
  return planes <= 32 ? 2 : 1;
}

// Shared-memory bytes of K11b (pruning/kernels.py::twist_fwd_smem
// mirrors it): P of a group double-buffered on both sides, pi, the
// warps' partials and, over several groups, each thread's M x SPT site
// sums.
size_t fwd_smem(int AB, int NG, int spt, bool multi, int G, int Ab, int M,
                int threads) {
  return (size_t)(4 * AB * AB * NG + (multi ? (G * Ab + 3) & ~3 : AB * NG) +
                  2 * kFwdMaxWarps + (multi ? M * spt * threads : 0)) *
         sizeof(float);
}

template <int AB, int NG, int SPT, bool EXACT, bool MULTI>
int launch_fwd(const float* m1, const float* m2, const float* Pl,
               const float* Pr, const float* pi, const float* w, float* part,
               int KC, int M, int G, int Ab, int S, int threads, int tiles,
               cudaStream_t st) {
  const size_t smem = fwd_smem(AB, NG, SPT, MULTI, G, Ab, M, threads);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = pair_ll_fwd_kernel<AB, NG, SPT, EXACT, MULTI>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const bool vecP = Ab % 4 == 0 && aligned(Pl, 16) && aligned(Pr, 16);
  const bool vecM = S % SPT == 0 && aligned(m1, 4 * SPT) &&
                    aligned(m2, 4 * SPT);
  kernel<<<dim3(KC, tiles), threads, smem, st>>>(
      m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S, vecP, vecM);
  return (int)cudaGetLastError();
}

template <int AB, int NG, int SPT>
int run_fwd(const float* m1, const float* m2, const float* Pl,
            const float* Pr, const float* pi, const float* w, float* part,
            int KC, int M, int G, int Ab, int S, int threads, int tiles,
            bool multi, cudaStream_t st) {
  if (threads < 32 || threads > kFwdMaxThreads || threads % 32 ||
      tiles < 1 || tiles > 65535 || (long long)tiles * threads * SPT < S)
    return (int)cudaErrorInvalidValue;
  // more blocks than one group holds: groups of kFwdGroup planes, or of
  // one block of 64
  if (multi) {
    if constexpr (AB * NG == kFwdGroup || AB == kFwdTile)
      return launch_fwd<AB, NG, SPT, false, true>(
          m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S, threads, tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  // up to 16 planes (primate, DS1 dense and GTR+Gamma4's blocks) an
  // instance with the shape folded in, about 1.4x quicker; wider
  // shapes share the guarded one (compile time)
  if constexpr (AB * NG <= 16) {
    if (G == NG && Ab == AB)
      return launch_fwd<AB, NG, SPT, true, false>(
          m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S, threads, tiles, st);
  }
  return launch_fwd<AB, NG, SPT, false, false>(
      m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S, threads, tiles, st);
}

// Shared-memory bytes K7 wide (tf false) and K11c (tf true) need at a
// chunk of SC sites and GB blocks a group (GB < G: M rows of site sums;
// pruning/kernels.py::twist_bwd_smem mirrors it).
size_t bwd_smem(int G, int Ab, int SC, bool tf, int GB, int M) {
  const int NPG = (Ab + 3) / 4, GAg = GB * Ab, GA = G * Ab;
  const int rows = GB < G ? M : 1;
  return ((size_t)(4 * GAg + GB * NPG + rows) * (SC + 4) +
          (8 + (tf ? 1 : 0)) * (size_t)GAg * 4 * NPG + ((GA + 3) & ~3)) *
         sizeof(float);
}

int launch_bwd(const float* m1, const float* m2, const float* Pl,
               const float* Pr, const float* pi, const float* w,
               const float* g, float* dm1, float* dm2, float* dPl,
               float* dPr, int KC, int M, int G, int Ab, int S, int SC,
               int threads, int smem, int GB, bool tf, void* stream) {
  if (KC <= 0) return 0;
  if (M < 0 || S <= 0 || G < 1 || G > kMaxG || Ab < 1 || Ab > kMaxStates ||
      GB < 1 || GB > G || SC < 4 || SC % 4 || SC > kBwdMaxSC)
    return (int)cudaErrorInvalidValue;
  const int NGT = GB * ((Ab + 3) / 4);
  if (threads % 32 || threads > kBwdMaxThreads || threads < NGT * (SC / 4) ||
      smem > kSmemMax || (size_t)smem < bwd_smem(G, Ab, SC, tf, GB, M))
    return (int)cudaErrorInvalidValue;
  auto kernel =
      GB < G ? (tf ? pair_ll_bwd_t_groups_kernel
                   : pair_ll_bwd_wide_groups_kernel)
      : tf   ? (Ab == 4    ? pair_ll_bwd_t_wide_kernel<4>
                : Ab == 16 ? pair_ll_bwd_t_wide_kernel<16>
                           : pair_ll_bwd_t_wide_kernel<0>)
             : (Ab == 4    ? pair_ll_bwd_wide_kernel<4>
                : Ab == 16 ? pair_ll_bwd_wide_kernel<16>
                           : pair_ll_bwd_wide_kernel<0>);
  const int err = allow_smem(kernel, (size_t)smem);
  if (err) return err;
  const bool vecM = S % 4 == 0 && aligned(m1, 16) && aligned(m2, 16);
  kernel<<<KC, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, G, Ab, S, SC, GB,
      vecM);
  return (int)cudaGetLastError();
}

}  // namespace

// K11b.  G = 1 is the dense form (Ab = A <= 64); blocked, G <= 32 blocks
// of Ab <= 64 states, all in one group while they fit 64 padded planes,
// else in groups of 32 (or of one block of 64).  spt, threads and tiles
// are the wrapper's plan (pruning/kernels.py::twist_fwd_plan); a plan
// that does not match the instantiation is refused.
extern "C" int launch_pair_ll_fwd(const float* m1, const float* m2,
                                  const float* Pl, const float* Pr,
                                  const float* pi, const float* w,
                                  float* part, int KC, int M, int G, int Ab,
                                  int S, int spt, int threads, int tiles,
                                  void* stream) {
  if (KC <= 0 || M <= 0) return 0;
  if (S <= 0 || G < 1 || G > kMaxG || Ab < 1 || Ab > kMaxStates)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int AB = pow2_at_least(Ab < 4 ? 4 : Ab);
  int NG = G == 1 ? 1 : pow2_at_least(G);
  if (NG * AB > kFwdTile) NG = AB < kFwdGroup ? kFwdGroup / AB : 1;
  const bool multi = G > NG;
#define PAIR_LL_FWD(ab, ng)                                               \
  if (AB == ab && NG == ng)                                               \
    return spt != fwd_spt(ab * ng)                                        \
               ? (int)cudaErrorInvalidValue                               \
               : run_fwd<ab, ng, fwd_spt(ab * ng)>(                       \
                     m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S,        \
                     threads, tiles, multi, st);
  PAIR_LL_FWD(4, 1)
  PAIR_LL_FWD(8, 1)
  PAIR_LL_FWD(16, 1)
  PAIR_LL_FWD(32, 1)
  PAIR_LL_FWD(64, 1)
  PAIR_LL_FWD(4, 2)
  PAIR_LL_FWD(4, 4)
  PAIR_LL_FWD(4, 8)
  PAIR_LL_FWD(4, 16)
  PAIR_LL_FWD(8, 2)
  PAIR_LL_FWD(8, 4)
  PAIR_LL_FWD(8, 8)
  PAIR_LL_FWD(16, 2)
  PAIR_LL_FWD(16, 4)
  PAIR_LL_FWD(32, 2)
#undef PAIR_LL_FWD
  return (int)cudaErrorInvalidValue;
}

// K7 wide.  G = 1 is the dense form (8 < Ab = A <= 64); blocked, G <= 32
// blocks of Ab <= 64 states, GB a group.  SC, threads, smem and GB are
// the wrapper's plan (pruning/kernels.py::twist_bwd_plan and
// ::twist_bwd_group), checked against the layout here.
extern "C" int launch_pair_ll_bwd_wide(const float* m1, const float* m2,
                                       const float* Pl, const float* Pr,
                                       const float* pi, const float* w,
                                       const float* g, float* dm1,
                                       float* dm2, float* dPl, float* dPr,
                                       int KC, int M, int G, int Ab, int S,
                                       int SC, int threads, int smem, int GB,
                                       void* stream) {
  return launch_bwd(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, G,
                    Ab, S, SC, threads, smem, GB, false, stream);
}

// K11c above 8 dense states and blocked (dense A <= 8:
// twist_kernels.cu's launch_pair_ll_bwd_t): K7 wide's plan in its
// T-field form.  The same outputs as K7 wide, dP_l and dP_r formed from T
// in the kernel.
extern "C" int launch_pair_ll_bwd_t(const float* m1, const float* m2,
                                    const float* Pl, const float* Pr,
                                    const float* pi, const float* w,
                                    const float* g, float* dm1, float* dm2,
                                    float* dPl, float* dPr, int KC, int M,
                                    int G, int Ab, int S, int SC,
                                    int threads, int smem, int GB,
                                    void* stream) {
  return launch_bwd(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, G,
                    Ab, S, SC, threads, smem, GB, true, stream);
}
