// Kernels K1, K2, K3 and K10 of phylo_tpu_torch: one rank of the CSMC
// sweep and its reverse.
//
// K1 replaces phylo_tpu/pruning/kernels.py::fused_rank_update (Pallas
// body _kernel_rank + _dma_gather_children).  K2 replaces
// ::fused_rank_bwd_saved (body _kernel_rank_bwd_saved -> _rank_bwd_core),
// K3 ::fused_rank_bwd (body _kernel_rank_bwd: K2's math with the children
// re-gathered from the leaves and the write-once buffer).  K10 are the
// blocked (G > 1) forms of the same three bodies, for the rate-mixture
// models (GammaSites / FreeRates): messages carry G*A planes, the
// transitions are (K, G, A, A) and the contraction stays inside each
// rate-category block.
//
// Layout: messages are states-major (A, S) slabs -- (G*A, S) blocked --
// contiguous in S; the write-once buffer is (K, R, A, S); idx is (4, K)
// int32 rows [row1, node1, row2, node2]; transitions are (K, A, A)
// row-major (blocked: (K, G, A, A)) with the merge contraction
// u[b] = sum_a m[a] P[a, b].
//
// What bounds them on an H100: bytes.  Per particle and site K1 reads
// two children (2A floats) and writes one merged message (A floats, plus
// 2A for saved children); the arithmetic is ~4 A^2 FMAs, far below the
// card's FP32 rate.  K2 reads children and the cotangent (3A floats)
// and writes two child cotangents (2A floats); K3 reads the same, its
// children from wherever the index points.  Blocked, every count is per
// plane of G*A and the arithmetic ~4 G A^2.  Most particles share a few
// child slabs (DS1's last rank: 6 slabs for 4,096 children), so the
// children come from L2 and the DRAM byte bound does not see their reads.
//
// Common design: one CUDA block per particle, warps striding over chunks
// of 32 SPL sites so neighbouring lanes read neighbouring addresses of
// each plane (coalesced).  Each block reads its own idx entries (the TPU
// kernel scalar-prefetched them).  The contractions run in exact FP32
// FMAs in registers (no tensor cores, no TF32), by block_merge's fixed
// chains in both directions.  The forward writes the rescaled column
// straight into buf[:, outc] IN PLACE (the TPU kernel aliased the
// buffer); the column written is never among the columns read.  Site
// sums (rootll, logscale, dP) are lane chains, warp reductions and the
// warps in warp order.  dpi and dw are sums over particles: instead of
// carrying them across a sequential grid as the TPU did, each block
// writes a partial row and the wrapper sums the rows with torch.sum
// (deterministic, no atomics).
//
// The forward (K1: the dense form, G = 1; K10's forward: the blocked
// form), fused_rank_fwd_kernel, takes one pass: a site's merged planes
// stay in registers (or the warp's shared-memory stage) until its max over
// all G*A planes is known, so every child value is read once.  On the
// H100 its time sits within about 25% of the sum of two probes of the
// same launch, the children's reads alone and the column's writes alone:
// the reads from L2 and the writes to DRAM hardly overlap (PERF.md).
// rank_fwd_plan sizes the lane's sites and the warps.

// The backward (K2, K3, K11a at A <= 8: the dense form, G = 1; K3
// blocked, K10's: the blocked form).  Bytes bound it (DS1
// GTR+Gamma4, K = 2048, S = 256: 0.0308 ms), so the card has to keep
// enough loads in flight: the former form, 8 particles a 128-thread block
// (256 blocks, ~8 warps an SM), a block-wide reduction of 36 values per
// (particle, block) through shared memory and five per-site scalars
// through a global scratch row, ran at 5.7x the bound.  Now a warp owns a
// (particle, chunk of 32 sites) and a block a particle (DS1: 16,384
// warps); the warp stages its chunk's children and cotangent in shared
// memory by cp.async (every load in flight at once), a lane keeps its
// sites' scalars in registers between the two passes and the 2 A^2 + A
// dP / dpi sums of one rate block in registers, and reduces them with
// one transpose_sum (about 36 shuffles, no barrier) a (chunk, block).
// The warps' sums meet once in shared memory, in warp order, and dP is
// written once.  K2, K3 and K11a at A <= 8 run this body's dense form
// (G = 1 at compile time, the children straight into registers and the
// merge kept from pass 1 for pass 2); their former body was the
// 8-particle layout above (3.8x its bound at primate K = 2048, S = 256,
// and 4 blocks at K11a's K = 32).  rank_bwd_plan halves the lane's sites
// while the grid would be short of warps.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

// The rank forward: warps a block at most, and the rate blocks and states
// a block of its register form at most (pruning/kernels.py mirrors them)
constexpr int kFwdMaxWarps = 8;
constexpr int kFwdRegBlocks = 4;
constexpr int kFwdRegStates = 4;
// The rank backward: sites a lane holds per chunk (blocked form), warps a
// block (pruning/kernels.py::rank_bwd_plan mirrors both)
constexpr int kBwdSPL = 1;
constexpr int kBwdMaxWarps = 8;

// The sum of v over a warp's 32 lanes, in every lane: a butterfly (pairs
// L, L ^ 16 first, then L ^ 8, ...), the same bits in every lane and call.
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// One rate-category block of the merge: u = Pl_g^T a1, v = Pr_g^T a2,
// w = u * v, in a fixed operation order (no FMA contraction choices), so
// the forward and the backward's passes get the same bits.
template <int A>
__device__ __forceinline__ void block_merge(const float* a1, const float* a2,
                                            const float* pl, const float* pr,
                                            float* u, float* v, float* wv) {
#pragma unroll
  for (int b = 0; b < A; ++b) {
    float uu = __fmul_rn(a1[0], pl[b]), vv = __fmul_rn(a2[0], pr[b]);
#pragma unroll
    for (int a = 1; a < A; ++a) {
      uu = __fmaf_rn(a1[a], pl[a * A + b], uu);
      vv = __fmaf_rn(a2[a], pr[a * A + b], vv);
    }
    u[b] = uu;
    v[b] = vv;
    wv[b] = __fmul_rn(uu, vv);
  }
}

template <int A>
__device__ __forceinline__ void load_block(const float* m, int g, int S,
                                           int s, float* a) {
#pragma unroll
  for (int i = 0; i < A; ++i) a[i] = m[(size_t)(g * A + i) * S + s];
}

// One rate-category block of P_l, P_r from shared memory into registers
// (float4 broadcasts where A^2 is a multiple of 4, so every block starts
// 16-byte aligned).
template <int A>
__device__ __forceinline__ void load_pblock(const float* pl, const float* pr,
                                            float* plg, float* prg) {
  if constexpr (A * A % 4 == 0) {
#pragma unroll
    for (int e = 0; e < A * A; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(pl + e);
      const float4 y = *reinterpret_cast<const float4*>(pr + e);
      plg[e] = x.x; plg[e + 1] = x.y; plg[e + 2] = x.z; plg[e + 3] = x.w;
      prg[e] = y.x; prg[e + 1] = y.y; prg[e + 2] = y.z; prg[e + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < A * A; ++e) {
      plg[e] = pl[e];
      prg[e] = pr[e];
    }
  }
}

// Shared memory of the blocked kernels: Pl (G A^2), Pr (G A^2), pi (G A).
__device__ __forceinline__ void load_transitions(
    float* pl, float* pr, const float* Pl, const float* Pr, int k, int npb) {
  for (int c = threadIdx.x; c < npb; c += blockDim.x) {
    pl[c] = Pl[(size_t)k * npb + c];
    pr[c] = Pr[(size_t)k * npb + c];
  }
}

// The rank forward: K1 (G = 1, transitions (K, A, A)) and K10's forward
// (G > 1 rate-category blocks of A <= 8 states, transitions (K, G, A,
// A)), `_kernel_rank`'s math: per particle k and site s the children m1,
// m2 (a leaf, or a column of the write-once buffer), the merge w = (P_l^T
// m1) * (P_r^T m2) by block_merge's chains (the rank backward's bits: its
// max and ties are the forward's), scale = max(max_p w_p, FLT_MIN), the
// column w / scale written to buf[k, outc], rootll_k = sum_s weight_s
// log(sum_p pi_p w_p) and logscale_k = sum_s weight_s log(scale_s).  One
// pass: every child value is read once, and w is kept until the site's
// max is known.
// One CUDA block per particle, `blockDim.x / 32` warps; warp w owns the
// site chunks c = w, w + W, ... of CH = 32 SPL sites (neighbouring warps
// write neighbouring chunks at about the same time), lane l the sites
// c CH + 32 j + l (j < SPL).  A lane's log terms form one chain over its
// sites in order (fused multiply-adds); the warp sums its lanes by a
// butterfly (xor 16, 8, 4, 2, 1) and the block its warps in warp order:
// the same bits in every call, no atomics.
// Two forms, chosen by fwd_blocks:
// * Registers (NG blocks at compile time: NG = 1 is the dense form, K1;
//   NG = kFwdRegBlocks serves every 1 < G <= NG at run time, the padded
//   blocks skipped): a lane loads its sites' 2 G A child values straight
//   into registers, every load of a chunk issued before the first store,
//   and keeps w there.  Dense, the transitions and pi sit in registers;
//   blocked, in shared memory, one block's A^2 pair at a time in
//   registers (float4 broadcasts).
// * Staged (NG = 0, 1 < G at run time: more planes than registers hold): a
//   warp stages its chunk's children (2 G A CH floats) in its own shared
//   memory by cp.async, every copy in flight at once, merges block by
//   block and writes each block's w over its own staged m1 values (a lane
//   only ever touches the sites it copied, so no barrier guards the
//   stage), then scales them into the column.
// The children are read through const __restrict__ views (leaves, bin)
// and the column written through bout: the same buffer, but column outc is
// never among the children read, so the views do not overlap and the
// loads need not wait behind the stores.  One reciprocal of the scale a
// site multiplies the planes (the plain version divides each, at most an
// ulp apart; a division a plane ran 19% slower at DS1's step shape), and,
// blocked, the column and saved children go out as streaming
// (evict-first) stores, which the L2 drains to DRAM while the children's
// reads go on (6-21% quicker blocked; dense, from 3% quicker to 6%
// slower, so plain there).  tools/torch_k1_k10_forms.py times both
// choices on the H100 from patched copies of this file.
template <int A, int SPL, int NG>
__global__ void __launch_bounds__(32 * kFwdMaxWarps) fused_rank_fwd_kernel(
    const float* __restrict__ leaves, const float* __restrict__ bin,
    float* __restrict__ bout, const int* __restrict__ idx,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ rootll, float* __restrict__ logscale,
    float* __restrict__ c1, float* __restrict__ c2, int K, int R, int N,
    int Gr, int S, int outc) {
  constexpr int AA = A * A;
  constexpr int CH = 32 * SPL;          // sites a chunk
  constexpr int NP = NG * A;            // register form: planes held
  const int G = NG == 1 ? 1 : Gr;
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int GA = G * A, npb = G * AA;
  const size_t slab = (size_t)GA * S;
  // blocked: Pl, Pr (G A^2 each), pi (G A); then the warps' sums (2 W)
  // and, staged, each warp's stage (2 G A CH)
  float* pl = smem;
  float* pr = pl + npb;
  float* pv = pr + npb;
  float* slot = NG == 1 ? smem : pv + GA;
  float* x1 = slot + 2 * W + (size_t)warp * 2 * GA * CH;
  float* x2 = x1 + GA * CH;
  const float* m1 = child_slab(leaves, bin, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, bin, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float* out = bout + ((size_t)k * R + outc) * slab;
  float* s1 = c1 ? c1 + (size_t)k * slab : nullptr;
  float* s2 = c2 ? c2 + (size_t)k * slab : nullptr;
  const int nch = (S + CH - 1) / CH;
  float lr = 0.f, ls = 0.f;             // the lane's rootll, logscale chains

  // blocked, streaming (evict-first) stores; dense, plain ones
  constexpr bool Stream = NG != 1;
  auto store = [](float* at, float x) {
    if (Stream) __stcs(at, x); else *at = x;
  };
  if constexpr (NG != 1) {
    load_transitions(pl, pr, Pl, Pr, k, npb);
    for (int c = threadIdx.x; c < GA; c += blockDim.x) pv[c] = pi[c];
    __syncthreads();                    // the transitions and pi
  }
  if constexpr (NG >= 1) {
    float pld[NG == 1 ? AA : 1], prd[NG == 1 ? AA : 1], pvd[NG == 1 ? A : 1];
    if constexpr (NG == 1) {
#pragma unroll
      for (int c = 0; c < AA; ++c) {
        pld[c] = Pl[(size_t)k * AA + c];
        prd[c] = Pr[(size_t)k * AA + c];
      }
#pragma unroll
      for (int a = 0; a < A; ++a) pvd[a] = pi[a];
    }
    for (int c = warp; c < nch; c += W) {
      const int s0 = c * CH + lane;
      float a1[SPL][NP], a2[SPL][NP], ws[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = s0 + 32 * j;
        const bool ok = s < S;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const bool on = ok && (NG == 1 || p < GA);
          const size_t at = (size_t)p * S + s;
          a1[j][p] = on ? __ldg(m1 + at) : 0.f;
          a2[j][p] = on ? __ldg(m2 + at) : 0.f;
        }
        ws[j] = ok ? w[s] : 0.f;
      }
      float wv[SPL][NP], raw[SPL], site[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        raw[j] = __int_as_float(0xff800000);  // -inf
        site[j] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (NG > 1 && g >= G) continue;
        float plg[AA], prg[AA], pvg[A];
        if constexpr (NG == 1) {
#pragma unroll
          for (int e = 0; e < AA; ++e) {
            plg[e] = pld[e];
            prg[e] = prd[e];
          }
#pragma unroll
          for (int b = 0; b < A; ++b) pvg[b] = pvd[b];
        } else {
          load_pblock<A>(pl + g * AA, pr + g * AA, plg, prg);
#pragma unroll
          for (int b = 0; b < A; ++b) pvg[b] = pv[g * A + b];
        }
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          float u[A], v[A];
          block_merge<A>(a1[j] + g * A, a2[j] + g * A, plg, prg, u, v,
                         wv[j] + g * A);
#pragma unroll
          for (int b = 0; b < A; ++b) {
            raw[j] = fmaxf(raw[j], wv[j][g * A + b]);
            site[j] = __fmaf_rn(wv[j][g * A + b], pvg[b], site[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = s0 + 32 * j;
        if (s >= S) continue;
        const float scale = fmaxf(raw[j], FLT_MIN);
        const float inv = 1.f / scale;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (NG > 1 && p >= GA) continue;
          const size_t at = (size_t)p * S + s;
          if (s1) {
            store(s1 + at, a1[j][p]);
            store(s2 + at, a2[j][p]);
          }
          store(out + at, wv[j][p] * inv);
        }
        lr = __fmaf_rn(logf(site[j]), ws[j], lr);
        ls = __fmaf_rn(logf(scale), ws[j], ls);
      }
    }
  } else {
    for (int c = warp; c < nch; c += W) {
      const int s0 = c * CH + lane;
      // this lane's sites of chunk c into the stage (planes-major, CH a
      // plane), padded sites zero
      for (int p = 0; p < GA; ++p) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = s0 + 32 * j, e = p * CH + 32 * j + lane;
          if (s < S) {
            const size_t at = (size_t)p * S + s;
            cp_async4(x1 + e, m1 + at);
            cp_async4(x2 + e, m2 + at);
          } else {
            x1[e] = x2[e] = 0.f;
          }
        }
      }
      float ws[SPL], raw[SPL], site[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = s0 + 32 * j;
        ws[j] = s < S ? w[s] : 0.f;
        raw[j] = __int_as_float(0xff800000);  // -inf
        site[j] = 0.f;
      }
      cp_async_wait_all();
      for (int g = 0; g < G; ++g) {
        float plg[AA], prg[AA];
        load_pblock<A>(pl + g * AA, pr + g * AA, plg, prg);
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int e = 32 * j + lane, s = s0 + 32 * j;
          float a1[A], a2[A], u[A], v[A], wv[A];
          load_block<A>(x1, g, CH, e, a1);
          load_block<A>(x2, g, CH, e, a2);
          if (s1 && s < S) {
#pragma unroll
            for (int a = 0; a < A; ++a) {
              store(s1 + (size_t)(g * A + a) * S + s, a1[a]);
              store(s2 + (size_t)(g * A + a) * S + s, a2[a]);
            }
          }
          block_merge<A>(a1, a2, plg, prg, u, v, wv);
#pragma unroll
          for (int b = 0; b < A; ++b) {
            x1[(g * A + b) * CH + e] = wv[b];
            raw[j] = fmaxf(raw[j], wv[b]);
            site[j] = __fmaf_rn(wv[b], pv[g * A + b], site[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int e = 32 * j + lane, s = s0 + 32 * j;
        if (s >= S) continue;
        const float scale = fmaxf(raw[j], FLT_MIN);
        const float inv = 1.f / scale;
        for (int p = 0; p < GA; ++p)
          store(out + (size_t)p * S + s, x1[p * CH + e] * inv);
        lr = __fmaf_rn(logf(site[j]), ws[j], lr);
        ls = __fmaf_rn(logf(scale), ws[j], ls);
      }
    }
  }
  lr = warp_allsum(lr);
  ls = warp_allsum(ls);
  if (lane == 0) {
    slot[2 * warp] = lr;
    slot[2 * warp + 1] = ls;
  }
  __syncthreads();
  if (threadIdx.x == 0) {               // the warps in warp order
    for (int q = 1; q < W; ++q) {
      lr += slot[2 * q];
      ls += slot[2 * q + 1];
    }
    rootll[k] = lr;
    logscale[k] = ls;
  }
}

// Sums the N values v over a warp's 32 lanes by recursive halving (a
// transpose reduction): at the xor-O step a lane keeps half of its
// values, sends the other half to its partner and adds the partner's copy
// of the half it keeps, so after the five steps (O = 16 .. 1) lane L holds
// the warp totals of indices [base, base + size) in v[0, size) (size may
// be 0), ceil(N / 32) or fewer of them.  Each total is the butterfly sum
// over lanes (pairs L, L^16 first, then L^8, ...): a fixed tree, the same
// bits in every call.  About N shuffles in all, against 5 N for N
// butterflies.  The caller sets base = 0, size = N.
template <int N, int O>
__device__ __forceinline__ void transpose_sum(float* v, int lane, int& base,
                                              int& size) {
  constexpr int H = (N + 1) / 2;
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = (H + i < N) ? v[H + i] : 0.f;
    const float x = __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
    v[i] = (up ? hi : lo) + x;
  }
  if (up) {
    base += H;
    size -= H;
  } else {
    size = min(size, H);
  }
  if constexpr (O > 1) transpose_sum<H, O / 2>(v, lane, base, size);
}

// Values a lane keeps after transpose_sum of n: n ceil-halved five times.
__host__ __device__ constexpr int halved5(int n) {
  for (int i = 0; i < 5; ++i) n = (n + 1) / 2;
  return n;
}

// Pass 1 of the backward for one site and one rate-category block: the
// site sum, the cotangent-weighted sum of w, the max over planes and its
// ties, each a fixed chain over the block's planes in order.
template <int A>
__device__ __forceinline__ void bwd_pass1(const float* wp, const float* gv,
                                          const float* pvb, float& site,
                                          float& gsum, float& raw,
                                          float& neq) {
#pragma unroll
  for (int b = 0; b < A; ++b) {
    const float x = wp[b];
    site = __fmaf_rn(x, pvb[b], site);
    gsum = __fmaf_rn(gv[b], x, gsum);
    if (x > raw) {
      raw = x;
      neq = 1.f;
    } else if (x == raw) {
      neq += 1.f;
    }
  }
}

// Pass 2 for one site and one block: the child cotangents y1 = P_l du,
// y2 = P_r dv, and the site's dP_l, dP_r and dpi terms added onto acc
// (2 A^2 + A values).  share is 1 / ties; inv, dsite, draw the site's
// scalars (all 0 on a padded site).
template <int A>
__device__ __forceinline__ void bwd_pass2(
    const float* a1, const float* a2, const float* u, const float* v,
    const float* wp, const float* gv, const float* pvb, const float* plg,
    const float* prg, float raw, float share, float inv, float dsite,
    float draw, float* acc, float* y1, float* y2) {
  constexpr int AA = A * A;
  float du[A], dv[A];
#pragma unroll
  for (int b = 0; b < A; ++b) {
    // reduce-max cotangent split evenly among tied planes
    const float sh = (wp[b] == raw) ? share : 0.f;
    const float dwp = gv[b] * inv + dsite * pvb[b] + draw * sh;
    du[b] = dwp * v[b];
    dv[b] = dwp * u[b];
    acc[2 * AA + b] = __fmaf_rn(dsite, wp[b], acc[2 * AA + b]);
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    float x1 = du[0] * plg[a * A], x2 = dv[0] * prg[a * A];
#pragma unroll
    for (int b = 1; b < A; ++b) {
      x1 = __fmaf_rn(du[b], plg[a * A + b], x1);
      x2 = __fmaf_rn(dv[b], prg[a * A + b], x2);
    }
    y1[a] = x1;
    y2[a] = x2;
#pragma unroll
    for (int b = 0; b < A; ++b) {
      acc[a * A + b] = __fmaf_rn(du[b], a1[a], acc[a * A + b]);
      acc[AA + a * A + b] = __fmaf_rn(dv[b], a2[a], acc[AA + a * A + b]);
    }
  }
}

// A site's scalars from pass 1 (padded sites carry nothing): 1/scale,
// dsite, dscale's max share, 1 / ties, and its dw (written when dw_part
// is given).
__device__ __forceinline__ void bwd_scalars(
    float raw, float site, float gsum, float& neq, float& inv, float& dsite,
    float& draw, int s, int S, const float* w, float grk, float glk,
    float* dw_row) {
  inv = dsite = draw = 0.f;
  neq = 1.f / neq;                      // eq / neq for eq in {0, 1}
  if (s < S) {
    const float scale = fmaxf(raw, FLT_MIN);
    const float ws = w[s];
    inv = 1.f / scale;
    dsite = (grk * ws) / site;
    const float dscale = (glk * ws) / scale - gsum * (inv * inv);
    // max(raw, tiny): full cotangent above the clamp, half at it
    draw = dscale * ((raw > FLT_MIN ? 1.f : 0.f) +
                     (raw == FLT_MIN ? 0.5f : 0.f));
    if (dw_row) dw_row[s] = grk * logf(site) + glk * logf(scale);
  }
}

// The rank backward: _rank_bwd_core for K2, K3 and K11a at A <= 8
// (Dense: G = 1, transitions (K, A, A)), K10's backward (saved children)
// and K3 blocked (G > 1).  Gather re-gathers the children by idx.
// One CUDA block per particle k, `blockDim.x / 32` warps; warp w owns the
// site chunks c = w, w + W, ... of CH = 32 SPL sites, lane l the sites
// c CH + 32 j + l (j < SPL).  Pass 1 keeps each site's scalars (1/scale,
// dsite, dscale's max share, tie count, max) in the lane's registers;
// pass 2 holds a block's 2 A^2 dP and A dpi sums in registers across the
// lane's sites, one transpose_sum a (chunk, block), added onto the
// warp's slot in shared memory in chunk order.  The block then sums the
// warps' slots in warp order and writes dP and the particle's dpi row
// once.  No global scratch, no float atomics.
// * Blocked (G at run time): a warp stages its chunk's children and
//   cotangent (3 G A CH floats) in its own shared memory by cp.async,
//   every load in flight at once; a lane only ever reads the sites it
//   copied, so no barrier guards the staging.  Pass 2 loops over the
//   blocks and recomputes each block's merge (block_merge: the same
//   bits), since a site's scale is the max over all G A planes.
// * Dense (G = 1): a lane loads its sites' 3 A SPL values straight into
//   registers and keeps u, v and w from pass 1 for pass 2, so the merge
//   runs once and nothing is staged (the blocked form at G = 1
//   recomputes it from shared memory).
// One barrier after the transitions load and one before the slot sum.
template <int A, bool Gather, int SPL, bool Dense>
__global__ void __launch_bounds__(32 * kBwdMaxWarps)
    fused_rank_bwd_blocked_kernel(
        const float* __restrict__ m1g, const float* __restrict__ m2g,
        const float* __restrict__ leaves, const float* __restrict__ buf,
        const int* __restrict__ idx, const float* __restrict__ gmg,
        const float* __restrict__ gr, const float* __restrict__ gl,
        const float* __restrict__ Pl, const float* __restrict__ Pr,
        const float* __restrict__ pi, const float* __restrict__ w,
        float* __restrict__ dm1g, float* __restrict__ dm2g,
        float* __restrict__ dPl, float* __restrict__ dPr,
        float* __restrict__ dpi_part, float* __restrict__ dw_part, int K,
        int R, int N, int Gr, int S) {
  constexpr int AA = A * A;
  constexpr int NV = 2 * AA + A;        // dP_l, dP_r and dpi of one block
  constexpr int NF = halved5(NV);       // values a lane keeps after the sum
  constexpr int CH = 32 * SPL;          // sites a chunk
  const int G = Dense ? 1 : Gr;
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int GA = G * A, npb = G * AA;
  const size_t slab = (size_t)GA * S;
  const int tile = Dense ? 0 : 3 * GA * CH;  // one staged chunk: x1, x2, gm
  float* pl = smem;
  float* pr = smem + npb;
  float* pv = smem + 2 * npb;
  float* slot = pv + GA;                // W x G x NV running sums
  float* myslot = slot + (size_t)warp * G * NV;
  float* mystage = slot + (size_t)W * G * NV + (size_t)warp * tile;
  load_transitions(pl, pr, Pl, Pr, k, npb);
  for (int c = threadIdx.x; c < GA; c += blockDim.x) pv[c] = pi[c];
  const float grk = gr[k], glk = gl[k];
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
  float* dw_row = dw_part ? dw_part + (size_t)k * S : nullptr;
  const int nch = (S + CH - 1) / CH;
  __syncthreads();                      // the transitions and pi

  if constexpr (Dense) {
    float plg[AA], prg[AA];
    load_pblock<A>(pl, pr, plg, prg);
    for (int c = warp, it = 0; c < nch; c += W, ++it) {
      const int s0 = c * CH + lane;
      float a1[SPL][A], a2[SPL][A], gv[SPL][A], u[SPL][A], v[SPL][A],
          wp[SPL][A];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = s0 + 32 * j;
        const bool ok = s < S;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const size_t at = (size_t)a * S + s;
          a1[j][a] = ok ? m1[at] : 0.f;
          a2[j][a] = ok ? m2[at] : 0.f;
          gv[j][a] = ok ? gm[at] : 0.f;
        }
      }
      float raw[SPL], neq[SPL], site[SPL], gsum[SPL];
      float inv[SPL], dsite[SPL], draw[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        raw[j] = __int_as_float(0xff800000);  // -inf
        neq[j] = site[j] = gsum[j] = 0.f;
        block_merge<A>(a1[j], a2[j], plg, prg, u[j], v[j], wp[j]);
        bwd_pass1<A>(wp[j], gv[j], pv, site[j], gsum[j], raw[j], neq[j]);
        bwd_scalars(raw[j], site[j], gsum[j], neq[j], inv[j], dsite[j],
                    draw[j], s0 + 32 * j, S, w, grk, glk, dw_row);
      }
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = s0 + 32 * j;
        float y1[A], y2[A];
        bwd_pass2<A>(a1[j], a2[j], u[j], v[j], wp[j], gv[j], pv, plg, prg,
                     raw[j], neq[j], inv[j], dsite[j], draw[j], acc, y1, y2);
        if (s < S) {
#pragma unroll
          for (int a = 0; a < A; ++a) {
            dm1[(size_t)a * S + s] = y1[a];
            dm2[(size_t)a * S + s] = y2[a];
          }
        }
      }
      int base = 0, size = NV;
      transpose_sum<NV, 16>(acc, lane, base, size);
      float* sl = myslot + base;
#pragma unroll
      for (int i = 0; i < NF; ++i)
        if (i < size) sl[i] = it ? sl[i] + acc[i] : acc[i];
    }
  } else {
    // this lane's sites of chunk c into stage x (planes-major, CH a plane)
    auto stage = [&](int c, float* x) {
      for (int p = 0; p < GA; ++p) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = c * CH + 32 * j + lane;
          float* d = x + p * CH + 32 * j + lane;
          if (s < S) {
            const size_t at = (size_t)p * S + s;
            cp_async4(d, m1 + at);
            cp_async4(d + GA * CH, m2 + at);
            cp_async4(d + 2 * GA * CH, gm + at);
          } else {
            d[0] = d[GA * CH] = d[2 * GA * CH] = 0.f;
          }
        }
      }
    };
    for (int c = warp, it = 0; c < nch; c += W, ++it) {
      const float* x1 = mystage;
      const float* x2 = x1 + GA * CH;
      const float* xg = x2 + GA * CH;
      stage(c, mystage);
      cp_async_wait_all();
      const int s0 = c * CH + lane;
      // pass 1, per site over all G*A planes: max, its ties, site sum
      float raw[SPL], neq[SPL], site[SPL], gsum[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        raw[j] = __int_as_float(0xff800000);  // -inf
        neq[j] = site[j] = gsum[j] = 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float plg[AA], prg[AA];
        load_pblock<A>(pl + g * AA, pr + g * AA, plg, prg);
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int e = 32 * j + lane;
          float a1[A], a2[A], gv[A], u[A], v[A], wp[A];
          load_block<A>(x1, g, CH, e, a1);
          load_block<A>(x2, g, CH, e, a2);
          load_block<A>(xg, g, CH, e, gv);
          block_merge<A>(a1, a2, plg, prg, u, v, wp);
          bwd_pass1<A>(wp, gv, pv + g * A, site[j], gsum[j], raw[j],
                       neq[j]);
        }
      }
      float inv[SPL], dsite[SPL], draw[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        bwd_scalars(raw[j], site[j], gsum[j], neq[j], inv[j], dsite[j],
                    draw[j], s0 + 32 * j, S, w, grk, glk, dw_row);

      // pass 2, one rate-category block at a time
      for (int g = 0; g < G; ++g) {
        float plg[AA], prg[AA];
        load_pblock<A>(pl + g * AA, pr + g * AA, plg, prg);
        float acc[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[e] = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int e = 32 * j + lane, s = s0 + 32 * j;
          float a1[A], a2[A], gv[A], u[A], v[A], wp[A], y1[A], y2[A];
          load_block<A>(x1, g, CH, e, a1);
          load_block<A>(x2, g, CH, e, a2);
          load_block<A>(xg, g, CH, e, gv);
          block_merge<A>(a1, a2, plg, prg, u, v, wp);
          bwd_pass2<A>(a1, a2, u, v, wp, gv, pv + g * A, plg, prg, raw[j],
                       neq[j], inv[j], dsite[j], draw[j], acc, y1, y2);
          if (s < S) {
#pragma unroll
            for (int a = 0; a < A; ++a) {
              dm1[(size_t)(g * A + a) * S + s] = y1[a];
              dm2[(size_t)(g * A + a) * S + s] = y2[a];
            }
          }
        }
        int base = 0, size = NV;
        transpose_sum<NV, 16>(acc, lane, base, size);
        float* sl = myslot + g * NV + base;
#pragma unroll
        for (int i = 0; i < NF; ++i)
          if (i < size) sl[i] = it ? sl[i] + acc[i] : acc[i];
      }
    }
  }
  __syncthreads();
  // the warps' slots in warp order: dP and the particle's dpi row, once
  for (int e = threadIdx.x; e < G * NV; e += blockDim.x) {
    float t = slot[e];
    for (int q = 1; q < W; ++q) t += slot[(size_t)q * G * NV + e];
    const int g = e / NV, v = e - g * NV;
    if (v < AA)
      dPl[(size_t)k * npb + g * AA + v] = t;
    else if (v < 2 * AA)
      dPr[(size_t)k * npb + g * AA + v - AA] = t;
    else
      dpi_part[(size_t)k * GA + g * A + v - 2 * AA] = t;
  }
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

static size_t blocked_smem(int G, int A) {
  return (size_t)(2 * G * A * A + G * A) * sizeof(float);
}

// The rank backward: transitions, pi, the warps' slots and, blocked, their
// staged chunks (3 G A CH floats a warp; the dense form stages nothing).
static size_t bwd_blocked_smem(int G, int A, int warps, int spl) {
  return blocked_smem(G, A) +
         (size_t)warps * G * (2 * A * A + A) * sizeof(float) +
         (G > 1 ? (size_t)warps * 3 * G * A * 32 * spl * sizeof(float) : 0);
}

template <typename Kernel>
static int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The rank forward's shared memory: the warps' two sums and, blocked
// (G > 1), the transitions and pi and, staged (ng = 0), each warp's stage
// (2 G A 32 spl floats).
static size_t fwd_smem(int G, int A, int warps, int spl, int ng) {
  size_t n = (size_t)2 * warps;
  if (ng != 1) n += 2 * G * A * A + G * A;
  if (ng == 0) n += (size_t)warps * 2 * G * A * 32 * spl;
  return n * sizeof(float);
}

// The rank forward's form (pruning/kernels.py::fwd_blocks mirrors it):
// the blocks the register form holds (1: dense; blocked, kFwdRegBlocks
// blocks of at most kFwdRegStates states, so at most 16 planes, for any
// G <= kFwdRegBlocks), or 0 for the staged form.
static int fwd_blocks(int G, int A) {
  if (G == 1) return 1;
  return A > kFwdRegStates || G > kFwdRegBlocks ? 0 : kFwdRegBlocks;
}

template <int A, int SPL, int NG>
static int launch_fwd_form(const float* leaves, float* buf, const int* idx,
                           const float* Pl, const float* Pr, const float* pi,
                           const float* w, float* rootll, float* logscale,
                           float* c1, float* c2, int K, int R, int N, int G,
                           int S, int outc, int warps, cudaStream_t st) {
  auto kernel = fused_rank_fwd_kernel<A, SPL, NG>;
  const size_t smem = fwd_smem(G, A, warps, SPL, NG);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<K, 32 * warps, smem, st>>>(leaves, buf, buf, idx, Pl, Pr, pi, w,
                                      rootll, logscale, c1, c2, K, R, N, G,
                                      S, outc);
  return (int)cudaGetLastError();
}

// The register form's instances of A <= kFwdRegStates states: dense at
// spl 1 or 2, blocked (kFwdRegBlocks blocks) at spl 1.
template <int A>
static int launch_fwd_reg(int ng, int spl, const float* leaves, float* buf,
                          const int* idx, const float* Pl, const float* Pr,
                          const float* pi, const float* w, float* rootll,
                          float* logscale, float* c1, float* c2, int K, int R,
                          int N, int G, int S, int outc, int warps,
                          cudaStream_t st) {
#define PHYLO_FWD_ARGS                                                     \
  leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1, c2, K, R, N, G, S, \
      outc, warps, st
  if (ng == 1 && spl == 1) return launch_fwd_form<A, 1, 1>(PHYLO_FWD_ARGS);
  if (ng == 1 && spl == 2) return launch_fwd_form<A, 2, 1>(PHYLO_FWD_ARGS);
  if (ng == 1 || spl != 1) return (int)cudaErrorInvalidValue;
  return launch_fwd_form<A, 1, kFwdRegBlocks>(PHYLO_FWD_ARGS);
}

// K1 (G = 1) and K10's forward (G > 1): spl and warps come from
// pruning/kernels.py::rank_fwd_plan (the register form: dense spl 1 or 2,
// blocked 1; the staged form 1).  c1, c2 may be null (no saved children).
extern "C" int launch_fused_rank_fwd(
    const float* leaves, float* buf, const int* idx, const float* Pl,
    const float* Pr, const float* pi, const float* w, float* rootll,
    float* logscale, float* c1, float* c2, int K, int R, int N, int G, int A,
    int S, int outc, int spl, int warps, void* stream) {
  if (K <= 0) return 0;
  if (G <= 0 || G > 32 || warps < 1 || warps > kFwdMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int ng = fwd_blocks(G, A);
  if (ng == 0 && spl != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_K1(AA)                                                      \
  case AA:                                                                \
    if (ng == 0) return launch_fwd_form<AA, 1, 0>(PHYLO_FWD_ARGS);        \
    if constexpr (AA <= kFwdRegStates) {                                  \
      return launch_fwd_reg<AA>(ng, spl, PHYLO_FWD_ARGS);                 \
    } else {                                                              \
      if (spl == 1) return launch_fwd_form<AA, 1, 1>(PHYLO_FWD_ARGS);     \
      if (spl == 2) return launch_fwd_form<AA, 2, 1>(PHYLO_FWD_ARGS);     \
      return (int)cudaErrorInvalidValue;                                  \
    }
    PHYLO_A_CASES(PHYLO_K1)
#undef PHYLO_K1
#undef PHYLO_FWD_ARGS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int A, bool Gather, int SPL, bool Dense>
static int launch_bwd_form(
    const float* m1, const float* m2, const float* leaves, const float* buf,
    const int* idx, const float* gm, const float* gr, const float* gl,
    const float* Pl, const float* Pr, const float* pi, const float* w,
    float* dm1, float* dm2, float* dPl, float* dPr, float* dpi_part,
    float* dw_part, int K, int R, int N, int G, int S, int warps,
    size_t smem, cudaStream_t st) {
  auto kernel = fused_rank_bwd_blocked_kernel<A, Gather, SPL, Dense>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<K, 32 * warps, smem, st>>>(m1, m2, leaves, buf, idx, gm, gr, gl,
                                      Pl, Pr, pi, w, dm1, dm2, dPl, dPr,
                                      dpi_part, dw_part, K, R, N, G, S);
  return (int)cudaGetLastError();
}

// spl and warps come from pruning/kernels.py::rank_bwd_plan: G = 1 runs
// the dense form at spl = 1 or 2, G > 1 the blocked form at kBwdSPL.  dw_part may be null (no dw wanted).
template <bool Gather>
static int launch_bwd_blocked(
    const float* m1, const float* m2, const float* leaves, const float* buf,
    const int* idx, const float* gm, const float* gr, const float* gl,
    const float* Pl, const float* Pr, const float* pi, const float* w,
    float* dm1, float* dm2, float* dPl, float* dPr, float* dpi_part,
    float* dw_part, int K, int R, int N, int G, int A, int S, int spl,
    int warps, void* stream) {
  if (K <= 0 || S <= 0) return 0;
  const bool dense = G == 1;
  const bool spl_ok =
      dense ? (spl == 1 || spl == 2) : spl == kBwdSPL;
  if (G <= 0 || !spl_ok || warps < 1 || warps > kBwdMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_blocked_smem(G, A, warps, spl);
#define PHYLO_BWD_ARGS                                                     \
  m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2, dPl, dPr, \
      dpi_part, dw_part, K, R, N, G, S, warps, smem, st
  switch (A) {
#define PHYLO_K10B(AA)                                                     \
  case AA:                                                                 \
    if (!dense)                                                            \
      return launch_bwd_form<AA, Gather, kBwdSPL, false>(PHYLO_BWD_ARGS);  \
    if (spl == 1)                                                          \
      return launch_bwd_form<AA, Gather, 1, true>(PHYLO_BWD_ARGS);         \
    return launch_bwd_form<AA, Gather, 2, true>(PHYLO_BWD_ARGS);
    PHYLO_A_CASES(PHYLO_K10B)
#undef PHYLO_K10B
#undef PHYLO_BWD_ARGS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int launch_fused_rank_bwd_saved_blocked(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, int K, int G, int A, int S, int spl,
    int warps, void* stream) {
  return launch_bwd_blocked<false>(
      m1, m2, nullptr, nullptr, nullptr, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2,
      dPl, dPr, dpi_part, dw_part, K, 0, 0, G, A, S, spl, warps, stream);
}

extern "C" int launch_fused_rank_bwd_blocked(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, int K, int R, int N, int G,
    int A, int S, int spl, int warps, void* stream) {
  return launch_bwd_blocked<true>(
      nullptr, nullptr, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1,
      dm2, dPl, dPr, dpi_part, dw_part, K, R, N, G, A, S, spl, warps,
      stream);
}
