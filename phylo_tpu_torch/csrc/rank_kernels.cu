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
// plane of G*A and the arithmetic ~4 G A^2.
//
// Design: one CUDA block per particle (K1) or per group of particles
// (K2, K3), threads striding over sites so neighbouring threads read
// neighbouring addresses of each plane (coalesced).  Each block reads
// its own idx entries (the TPU kernel scalar-prefetched them).  The
// 4x4 contraction runs in exact FP32 FMAs in registers (no tensor
// cores, no TF32).  K1 writes the rescaled column straight into
// buf[:, outc] IN PLACE (the TPU kernel aliased the buffer); the column
// written is never among the columns read.  Site sums (rootll,
// logscale, dP) are block reductions in a fixed order.  dpi and dw are
// sums over particles: instead of carrying them across a sequential
// grid as the TPU did, each block writes a partial row and the wrapper
// sums the rows with torch.sum (deterministic, no atomics).
//
// The blocked kernels take G at run time and keep only one block's A
// planes in registers: a site's scale is the max over ALL G*A planes,
// so each site is done in two passes over the blocks, the second
// re-reading its children (from L1/L2) and recomputing the block's
// merge bit for bit (explicit __fmaf_rn / __fmul_rn, never contracted
// differently).  The transitions sit in shared memory (2 G A^2 floats).
// The backward's first pass leaves five per-site scalars (1/scale,
// dsite, dscale, tie count, max) in a global scratch row of its block;
// its second pass loops over the blocks outermost, so only one block's
// 2 A^2 dP sums (+ A dpi sums) are live, one block reduction per block.
// Ties of the max are counted across all G*A planes in the first pass.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of NV per-thread values; the result is valid in
// thread 0.  `sh` holds 32 * NV floats.  Every thread must call it.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // a previous call's readers are done with sh
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) sh[warp * NV + i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float x = lane < nwarps ? sh[lane * NV + i] : 0.f;
      v[i] = warp_sum(x);
    }
  }
}

__device__ __forceinline__ const float* child_slab(
    const float* leaves, const float* buf, int row, int node, int N, int R,
    size_t slab) {
  return node < N ? leaves + (size_t)node * slab
                  : buf + ((size_t)row * R + (node - N)) * slab;
}

template <int A>
__global__ void __launch_bounds__(kThreads) fused_rank_kernel(
    const float* __restrict__ leaves, float* buf,
    const int* __restrict__ idx, const float* __restrict__ Pl,
    const float* __restrict__ Pr, const float* __restrict__ pi,
    const float* __restrict__ w, float* __restrict__ rootll,
    float* __restrict__ logscale, float* __restrict__ c1,
    float* __restrict__ c2, int K, int R, int N, int S, int outc) {
  __shared__ float sh[32 * 2];
  const int k = blockIdx.x;
  const size_t slab = (size_t)A * S;
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float pl[A * A], pr[A * A], pv[A];
#pragma unroll
  for (int c = 0; c < A * A; ++c) {
    pl[c] = Pl[(size_t)k * A * A + c];
    pr[c] = Pr[(size_t)k * A * A + c];
  }
#pragma unroll
  for (int a = 0; a < A; ++a) pv[a] = pi[a];
  float* out = buf + ((size_t)k * R + outc) * slab;
  float* s1 = c1 ? c1 + (size_t)k * slab : nullptr;
  float* s2 = c2 ? c2 + (size_t)k * slab : nullptr;

  float acc[2] = {0.f, 0.f};
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float a1[A], a2[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      a1[a] = m1[(size_t)a * S + s];
      a2[a] = m2[(size_t)a * S + s];
    }
    if (s1) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        s1[(size_t)a * S + s] = a1[a];
        s2[(size_t)a * S + s] = a2[a];
      }
    }
    float wv[A];
#pragma unroll
    for (int b = 0; b < A; ++b) {
      float u = a1[0] * pl[b], v = a2[0] * pr[b];
#pragma unroll
      for (int a = 1; a < A; ++a) {
        u += a1[a] * pl[a * A + b];
        v += a2[a] * pr[a * A + b];
      }
      wv[b] = u * v;
    }
    float raw = wv[0];
#pragma unroll
    for (int b = 1; b < A; ++b) raw = fmaxf(raw, wv[b]);
    const float scale = fmaxf(raw, FLT_MIN);
    float site = wv[0] * pv[0];
#pragma unroll
    for (int b = 0; b < A; ++b) {
      out[(size_t)b * S + s] = wv[b] / scale;
      if (b) site += wv[b] * pv[b];
    }
    const float ws = w[s];
    acc[0] += logf(site) * ws;
    acc[1] += logf(scale) * ws;
  }
  block_sum<2>(acc, sh);
  if (threadIdx.x == 0) {
    rootll[k] = acc[0];
    logscale[k] = acc[1];
  }
}

template <int A, bool Gather>
__global__ void __launch_bounds__(kThreads) fused_rank_bwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ leaves, const float* __restrict__ buf,
    const int* __restrict__ idx, const float* __restrict__ gmg,
    const float* __restrict__ gr, const float* __restrict__ gl,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ dm1g, float* __restrict__ dm2g,
    float* __restrict__ dPl, float* __restrict__ dPr,
    float* __restrict__ dpi_part, float* __restrict__ dw_part, int K, int R,
    int N, int S, int tkb) {
  constexpr int NP = 2 * A * A;
  __shared__ float sh[32 * NP];
  const int blk = blockIdx.x;
  const int k0 = blk * tkb;
  const int k1 = min(K, k0 + tkb);
  const size_t slab = (size_t)A * S;
  float pv[A];
#pragma unroll
  for (int a = 0; a < A; ++a) pv[a] = pi[a];
  float dpi_acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) dpi_acc[a] = 0.f;
  float* dw_row = dw_part + (size_t)blk * S;

  for (int k = k0; k < k1; ++k) {
    float pl[A * A], pr[A * A];
#pragma unroll
    for (int c = 0; c < A * A; ++c) {
      pl[c] = Pl[(size_t)k * A * A + c];
      pr[c] = Pr[(size_t)k * A * A + c];
    }
    const float grk = gr[k], glk = gl[k];
    const float* m1 =
        Gather ? child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab)
               : m1g + (size_t)k * slab;
    const float* m2 =
        Gather ? child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N,
                            R, slab)
               : m2g + (size_t)k * slab;
    const float* gm = gmg + (size_t)k * slab;
    float* dm1 = dm1g + (size_t)k * slab;
    float* dm2 = dm2g + (size_t)k * slab;
    float dP[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) dP[c] = 0.f;

    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float a1[A], a2[A], g[A], u[A], v[A], wp[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        a1[a] = m1[(size_t)a * S + s];
        a2[a] = m2[(size_t)a * S + s];
        g[a] = gm[(size_t)a * S + s];
      }
#pragma unroll
      for (int b = 0; b < A; ++b) {
        float uu = a1[0] * pl[b], vv = a2[0] * pr[b];
#pragma unroll
        for (int a = 1; a < A; ++a) {
          uu += a1[a] * pl[a * A + b];
          vv += a2[a] * pr[a * A + b];
        }
        u[b] = uu;
        v[b] = vv;
        wp[b] = uu * vv;
      }
      float site = wp[0] * pv[0];
      float raw = wp[0];
#pragma unroll
      for (int b = 1; b < A; ++b) {
        site += wp[b] * pv[b];
        raw = fmaxf(raw, wp[b]);
      }
      const float scale = fmaxf(raw, FLT_MIN);
      const float ws = w[s];
      const float dsite = (grk * ws) / site;
      const float inv = 1.f / scale;
      float dscale = (glk * ws) / scale;
#pragma unroll
      for (int p = 0; p < A; ++p) dscale -= g[p] * (wp[p] * inv * inv);
      // max(raw, tiny): full cotangent above the clamp, half at it
      const float draw =
          dscale * ((raw > FLT_MIN ? 1.f : 0.f) + (raw == FLT_MIN ? 0.5f : 0.f));
      // reduce-max cotangent split evenly among tied planes
      float neq = 0.f;
#pragma unroll
      for (int p = 0; p < A; ++p) neq += (wp[p] == raw) ? 1.f : 0.f;
      float du[A], dv[A];
#pragma unroll
      for (int b = 0; b < A; ++b) {
        const float eq = (wp[b] == raw) ? 1.f : 0.f;
        const float dwp = g[b] * inv + dsite * pv[b] + draw * (eq / neq);
        du[b] = dwp * v[b];
        dv[b] = dwp * u[b];
        dpi_acc[b] += dsite * wp[b];
      }
#pragma unroll
      for (int a = 0; a < A; ++a) {
        float x1 = du[0] * pl[a * A], x2 = dv[0] * pr[a * A];
#pragma unroll
        for (int b = 1; b < A; ++b) {
          x1 += du[b] * pl[a * A + b];
          x2 += dv[b] * pr[a * A + b];
        }
        dm1[(size_t)a * S + s] = x1;
        dm2[(size_t)a * S + s] = x2;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          dP[a * A + b] += du[b] * a1[a];
          dP[A * A + a * A + b] += dv[b] * a2[a];
        }
      }
      // site-weight cotangent; this thread owns site s for every k
      const float dwv = grk * logf(site) + glk * logf(scale);
      dw_row[s] = (k == k0) ? dwv : dw_row[s] + dwv;
    }
    block_sum<NP>(dP, sh);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < A * A; ++c) {
        dPl[(size_t)k * A * A + c] = dP[c];
        dPr[(size_t)k * A * A + c] = dP[A * A + c];
      }
    }
  }
  block_sum<A>(dpi_acc, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a < A; ++a) dpi_part[(size_t)blk * A + a] = dpi_acc[a];
  }
}


// One rate-category block of the merge: u = Pl_g^T a1, v = Pr_g^T a2,
// w = u * v, in a fixed operation order (no FMA contraction choices), so
// the two passes of the blocked kernels get the same bits.
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

// Shared memory of the blocked kernels: Pl (G A^2), Pr (G A^2), pi (G A).
__device__ __forceinline__ void load_transitions(
    float* pl, float* pr, const float* Pl, const float* Pr, int k, int npb) {
  for (int c = threadIdx.x; c < npb; c += blockDim.x) {
    pl[c] = Pl[(size_t)k * npb + c];
    pr[c] = Pr[(size_t)k * npb + c];
  }
}

// K10 forward: K1 with transitions (K, G, A, A) and G*A-plane messages.
template <int A>
__global__ void __launch_bounds__(kThreads) fused_rank_blocked_kernel(
    const float* __restrict__ leaves, float* buf,
    const int* __restrict__ idx, const float* __restrict__ Pl,
    const float* __restrict__ Pr, const float* __restrict__ pi,
    const float* __restrict__ w, float* __restrict__ rootll,
    float* __restrict__ logscale, float* __restrict__ c1,
    float* __restrict__ c2, int K, int R, int N, int G, int S, int outc) {
  extern __shared__ float smem[];
  __shared__ float sh[32 * 2];
  const int k = blockIdx.x;
  const int GA = G * A, npb = G * A * A;
  float* pl = smem;
  float* pr = smem + npb;
  float* pv = smem + 2 * npb;
  load_transitions(pl, pr, Pl, Pr, k, npb);
  for (int c = threadIdx.x; c < GA; c += blockDim.x) pv[c] = pi[c];
  __syncthreads();
  const size_t slab = (size_t)GA * S;
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float* out = buf + ((size_t)k * R + outc) * slab;
  float* s1 = c1 ? c1 + (size_t)k * slab : nullptr;
  float* s2 = c2 ? c2 + (size_t)k * slab : nullptr;

  float acc[2] = {0.f, 0.f};
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float raw = __int_as_float(0xff800000), site = 0.f;  // -inf
    for (int g = 0; g < G; ++g) {          // pass 1: max and site sum
      float a1[A], a2[A], u[A], v[A], wv[A];
      load_block<A>(m1, g, S, s, a1);
      load_block<A>(m2, g, S, s, a2);
      if (s1) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          s1[(size_t)(g * A + a) * S + s] = a1[a];
          s2[(size_t)(g * A + a) * S + s] = a2[a];
        }
      }
      block_merge<A>(a1, a2, pl + g * A * A, pr + g * A * A, u, v, wv);
#pragma unroll
      for (int b = 0; b < A; ++b) {
        raw = fmaxf(raw, wv[b]);
        site = __fmaf_rn(wv[b], pv[g * A + b], site);
      }
    }
    const float scale = fmaxf(raw, FLT_MIN);
    for (int g = 0; g < G; ++g) {          // pass 2: the rescaled column
      float a1[A], a2[A], u[A], v[A], wv[A];
      load_block<A>(m1, g, S, s, a1);
      load_block<A>(m2, g, S, s, a2);
      block_merge<A>(a1, a2, pl + g * A * A, pr + g * A * A, u, v, wv);
#pragma unroll
      for (int b = 0; b < A; ++b) out[(size_t)(g * A + b) * S + s] = wv[b] / scale;
    }
    const float ws = w[s];
    acc[0] += logf(site) * ws;
    acc[1] += logf(scale) * ws;
  }
  block_sum<2>(acc, sh);
  if (threadIdx.x == 0) {
    rootll[k] = acc[0];
    logscale[k] = acc[1];
  }
}

// K10 backward (Gather=false, saved children) and K3 blocked
// (Gather=true, children re-gathered by idx): _rank_bwd_core with G > 1.
template <int A, bool Gather>
__global__ void __launch_bounds__(kThreads) fused_rank_bwd_blocked_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ leaves, const float* __restrict__ buf,
    const int* __restrict__ idx, const float* __restrict__ gmg,
    const float* __restrict__ gr, const float* __restrict__ gl,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ dm1g, float* __restrict__ dm2g,
    float* __restrict__ dPl, float* __restrict__ dPr,
    float* __restrict__ dpi_part, float* __restrict__ dw_part,
    float* __restrict__ scratch, int K, int R, int N, int G, int S,
    int tkb) {
  constexpr int AA = A * A;
  constexpr int NV = 2 * AA + A;        // dP_l, dP_r and dpi of one block
  extern __shared__ float smem[];
  __shared__ float sh[32 * NV];
  const int blk = blockIdx.x;
  const int k0 = blk * tkb;
  const int k1 = min(K, k0 + tkb);
  const int GA = G * A, npb = G * AA;
  const size_t slab = (size_t)GA * S;
  float* pl = smem;
  float* pr = smem + npb;
  float* pv = smem + 2 * npb;
  for (int c = threadIdx.x; c < GA; c += blockDim.x) pv[c] = pi[c];
  float* sc = scratch + (size_t)blk * 5 * S;  // this block's site scalars
  float* dw_row = dw_part + (size_t)blk * S;
  float* dpi_row = dpi_part + (size_t)blk * GA;

  for (int k = k0; k < k1; ++k) {
    __syncthreads();                      // the last particle's readers
    load_transitions(pl, pr, Pl, Pr, k, npb);
    __syncthreads();
    const float grk = gr[k], glk = gl[k];
    const float* m1 =
        Gather ? child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab)
               : m1g + (size_t)k * slab;
    const float* m2 =
        Gather ? child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N,
                            R, slab)
               : m2g + (size_t)k * slab;
    const float* gm = gmg + (size_t)k * slab;
    float* dm1 = dm1g + (size_t)k * slab;
    float* dm2 = dm2g + (size_t)k * slab;

    // pass 1, per site over all G*A planes: max, its ties, site sum
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float raw = __int_as_float(0xff800000);  // -inf
      float neq = 0.f, site = 0.f, gsum = 0.f;
      for (int g = 0; g < G; ++g) {
        float a1[A], a2[A], u[A], v[A], wp[A];
        load_block<A>(m1, g, S, s, a1);
        load_block<A>(m2, g, S, s, a2);
        block_merge<A>(a1, a2, pl + g * AA, pr + g * AA, u, v, wp);
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const int p = g * A + b;
          const float x = wp[b];
          site = __fmaf_rn(x, pv[p], site);
          gsum = __fmaf_rn(gm[(size_t)p * S + s], x, gsum);
          if (x > raw) {
            raw = x;
            neq = 1.f;
          } else if (x == raw) {
            neq += 1.f;
          }
        }
      }
      const float scale = fmaxf(raw, FLT_MIN);
      const float ws = w[s];
      const float inv = 1.f / scale;
      const float dscale = (glk * ws) / scale - gsum * (inv * inv);
      // max(raw, tiny): full cotangent above the clamp, half at it
      const float draw =
          dscale * ((raw > FLT_MIN ? 1.f : 0.f) + (raw == FLT_MIN ? 0.5f : 0.f));
      sc[s] = inv;
      sc[S + s] = (grk * ws) / site;      // dsite
      sc[2 * S + s] = draw;
      sc[3 * S + s] = neq;
      sc[4 * S + s] = raw;
      // site-weight cotangent; this thread owns site s for every k
      const float dwv = grk * logf(site) + glk * logf(scale);
      dw_row[s] = (k == k0) ? dwv : dw_row[s] + dwv;
    }

    // pass 2, one rate-category block at a time
    for (int g = 0; g < G; ++g) {
      const float* plg = pl + g * AA;
      const float* prg = pr + g * AA;
      float acc[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] = 0.f;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float inv = sc[s], dsite = sc[S + s], draw = sc[2 * S + s];
        const float neq = sc[3 * S + s], raw = sc[4 * S + s];
        float a1[A], a2[A], u[A], v[A], wp[A], du[A], dv[A];
        load_block<A>(m1, g, S, s, a1);
        load_block<A>(m2, g, S, s, a2);
        block_merge<A>(a1, a2, plg, prg, u, v, wp);
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const int p = g * A + b;
          // reduce-max cotangent split evenly among tied planes
          const float eq = (wp[b] == raw) ? 1.f : 0.f;
          const float dwp = gm[(size_t)p * S + s] * inv + dsite * pv[p] +
                            draw * (eq / neq);
          du[b] = dwp * v[b];
          dv[b] = dwp * u[b];
          acc[2 * AA + b] += dsite * wp[b];
        }
#pragma unroll
        for (int a = 0; a < A; ++a) {
          float x1 = du[0] * plg[a * A], x2 = dv[0] * prg[a * A];
#pragma unroll
          for (int b = 1; b < A; ++b) {
            x1 += du[b] * plg[a * A + b];
            x2 += dv[b] * prg[a * A + b];
          }
          dm1[(size_t)(g * A + a) * S + s] = x1;
          dm2[(size_t)(g * A + a) * S + s] = x2;
#pragma unroll
          for (int b = 0; b < A; ++b) {
            acc[a * A + b] += du[b] * a1[a];
            acc[AA + a * A + b] += dv[b] * a2[a];
          }
        }
      }
      block_sum<NV>(acc, sh);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < AA; ++c) {
          dPl[(size_t)k * npb + g * AA + c] = acc[c];
          dPr[(size_t)k * npb + g * AA + c] = acc[AA + c];
        }
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const float x = acc[2 * AA + b];
          dpi_row[g * A + b] = (k == k0) ? x : dpi_row[g * A + b] + x;
        }
      }
    }
  }
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

extern "C" int launch_fused_rank(const float* leaves, float* buf,
                                 const int* idx, const float* Pl,
                                 const float* Pr, const float* pi,
                                 const float* w, float* rootll,
                                 float* logscale, float* c1, float* c2,
                                 int K, int R, int N, int A, int S, int outc,
                                 void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_K1(AA)                                                    \
  case AA:                                                              \
    fused_rank_kernel<AA><<<K, kThreads, 0, st>>>(                      \
        leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1, c2, K, R, \
        N, S, outc);                                                    \
    break;
    PHYLO_A_CASES(PHYLO_K1)
#undef PHYLO_K1
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_fused_rank_bwd_saved(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, int K, int A, int S, int tkb,
    void* stream) {
  if (K <= 0) return 0;
  if (tkb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (K + tkb - 1) / tkb;
  switch (A) {
#define PHYLO_K2(AA)                                                       \
  case AA:                                                                 \
    fused_rank_bwd_kernel<AA, false><<<nb, kThreads, 0, st>>>(             \
        m1, m2, nullptr, nullptr, nullptr, gm, gr, gl, Pl, Pr, pi, w, dm1, \
        dm2, dPl, dPr, dpi_part, dw_part, K, 0, 0, S, tkb);                \
    break;
    PHYLO_A_CASES(PHYLO_K2)
#undef PHYLO_K2
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_fused_rank_bwd(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, int K, int R, int N, int A,
    int S, int tkb, void* stream) {
  if (K <= 0) return 0;
  if (tkb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (K + tkb - 1) / tkb;
  switch (A) {
#define PHYLO_K3(AA)                                                       \
  case AA:                                                                 \
    fused_rank_bwd_kernel<AA, true><<<nb, kThreads, 0, st>>>(              \
        nullptr, nullptr, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w,     \
        dm1, dm2, dPl, dPr, dpi_part, dw_part, K, R, N, S, tkb);           \
    break;
    PHYLO_A_CASES(PHYLO_K3)
#undef PHYLO_K3
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

static size_t blocked_smem(int G, int A) {
  return (size_t)(2 * G * A * A + G * A) * sizeof(float);
}

extern "C" int launch_fused_rank_blocked(
    const float* leaves, float* buf, const int* idx, const float* Pl,
    const float* Pr, const float* pi, const float* w, float* rootll,
    float* logscale, float* c1, float* c2, int K, int R, int N, int G, int A,
    int S, int outc, void* stream) {
  if (K <= 0) return 0;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = blocked_smem(G, A);
  switch (A) {
#define PHYLO_K10F(AA)                                                     \
  case AA:                                                                 \
    fused_rank_blocked_kernel<AA><<<K, kThreads, smem, st>>>(              \
        leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1, c2, K, R,   \
        N, G, S, outc);                                                    \
    break;
    PHYLO_A_CASES(PHYLO_K10F)
#undef PHYLO_K10F
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool Gather>
static int launch_bwd_blocked(
    const float* m1, const float* m2, const float* leaves, const float* buf,
    const int* idx, const float* gm, const float* gr, const float* gl,
    const float* Pl, const float* Pr, const float* pi, const float* w,
    float* dm1, float* dm2, float* dPl, float* dPr, float* dpi_part,
    float* dw_part, float* scratch, int K, int R, int N, int G, int A, int S,
    int tkb, void* stream) {
  if (K <= 0) return 0;
  if (tkb <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (K + tkb - 1) / tkb;
  const size_t smem = blocked_smem(G, A);
  switch (A) {
#define PHYLO_K10B(AA)                                                     \
  case AA:                                                                 \
    fused_rank_bwd_blocked_kernel<AA, Gather><<<nb, kThreads, smem, st>>>( \
        m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2,     \
        dPl, dPr, dpi_part, dw_part, scratch, K, R, N, G, S, tkb);         \
    break;
    PHYLO_A_CASES(PHYLO_K10B)
#undef PHYLO_K10B
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_fused_rank_bwd_saved_blocked(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, float* scratch, int K, int G, int A,
    int S, int tkb, void* stream) {
  return launch_bwd_blocked<false>(
      m1, m2, nullptr, nullptr, nullptr, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2,
      dPl, dPr, dpi_part, dw_part, scratch, K, 0, 0, G, A, S, tkb, stream);
}

extern "C" int launch_fused_rank_bwd_blocked(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, float* scratch, int K, int R,
    int N, int G, int A, int S, int tkb, void* stream) {
  return launch_bwd_blocked<true>(
      nullptr, nullptr, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1,
      dm2, dPl, dPr, dpi_part, dw_part, scratch, K, R, N, G, A, S, tkb,
      stream);
}
