// Kernels K9 of phylo_tpu_torch: the wide bodies of the rank update and
// its two backwards, for dense messages of 8 < A <= 128 states (codon
// GY94: A = 61; dense protein: A = 20).
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
// max(raw, tiny) half-split.  Layouts are the same: states-major (A, S)
// messages, (K, R, A, S) buffer, idx (4, K) = [row1, node1, row2, node2],
// (K, A, A) row-major transitions.
//
// What bounds them on an H100: operations.  Per particle and site the
// forward does 2 A^2 FMAs (A = 61: 7,442) against 3 A floats of traffic
// (5 A with saved children), ~600 FLOP per byte, far above the card's
// FP32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP/B); the backwards do
// 6 A^2 FMAs.  The TPU ran the contractions on its MXU in a multi-pass
// exact-f32 emulation; here they are FP32 FMAs on the CUDA cores (no
// tensor cores: no TF32, no wgmma), in a fixed order.
//
// Design.  A tile is 32 sites (one warp's width) x all A planes, staged
// in shared memory with a pitch of 33 floats, so a warp reading one
// plane's 32 sites and a warp reading 32 planes' same site are both
// free of bank conflicts.  P_l, P_r (2 A^2 floats) and pi sit in shared
// memory for the whole block; dynamic shared memory above 48 KB is
// opted into per kernel.  Every u[b, s] and v[b, s] is the same FMA
// chain (a ascending from 0, one rounding per step, `contract_pair`) in
// the forward and both backwards, so the backward's tie test w == max
// sees the forward's bits.
// * K9f: one block per (particle, site tile), 256 threads; a warp owns
//   a set of planes, a lane a site.  Warp 0 then reduces each site over
//   the A planes (max, pi-sum) in plane order, writes w / scale into
//   buffer column outc IN PLACE (the column written is never among the
//   columns read) and one partial rootll / logscale per tile, which the
//   wrapper sums with torch.sum (fixed order, no atomics).
// * K9bs / K9b: one block per particle looping over the site tiles (the
//   `Gather` template flag picks saved or re-gathered children, as PR
//   3's K2 / K3 share a body).  Per tile: u, v; warp 0's per-site
//   scalars (1/scale, dsite, dscale's max share, tie count, max); du, dv
//   in place of the cotangent tile and of u; dm1 = P_l du, dm2 = P_r dv
//   straight to global memory; and dP_l[a, b] += sum_s m1[a, s] du[b, s]
//   (likewise dP_r): the 2 A^2 accumulators of the particle are spread
//   over the block's threads (16 a side with 256 threads for A <= 64,
//   32 with 512 for A <= 128) and live in registers across all tiles.
//   dpi and dw come back as per-particle partial rows.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kTile = 32;          // sites per tile: one warp's lanes
constexpr int kPitch = kTile + 1;  // shared-memory row pitch
constexpr int kFwdThreads = 256;
constexpr int kMaxA = 128;
constexpr int kRowsPerThread = 8;  // planes a backward thread owns

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ const float* child_slab(
    const float* leaves, const float* buf, int row, int node, int N, int R,
    size_t slab) {
  return node < N ? leaves + (size_t)node * slab
                  : buf + ((size_t)row * R + (node - N)) * slab;
}

// Stage the (A, kTile) tile of message m (A, S) at site s0 in x (pitch
// kPitch), zeros past S; with `save`, copy what was read there too.
__device__ __forceinline__ void load_tile(const float* m, float* x, int A,
                                          int S, int s0, float* save) {
  for (int e = threadIdx.x; e < A * kTile; e += blockDim.x) {
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

// Transitions and pi into shared memory.
__device__ __forceinline__ void load_params(float* pl, float* pr, float* pv,
                                            const float* Pl, const float* Pr,
                                            const float* pi, int k, int A) {
  const int AA = A * A;
  for (int c = threadIdx.x; c < AA; c += blockDim.x) {
    pl[c] = Pl[(size_t)k * AA + c];
    pr[c] = Pr[(size_t)k * AA + c];
  }
  for (int c = threadIdx.x; c < A; c += blockDim.x) pv[c] = pi[c];
}

// K9f.  grid (K, T), T = ceil(S / kTile); partial rows (K, T).
__global__ void __launch_bounds__(kFwdThreads) wide_rank_kernel(
    const float* __restrict__ leaves, float* buf,
    const int* __restrict__ idx, const float* __restrict__ Pl,
    const float* __restrict__ Pr, const float* __restrict__ pi,
    const float* __restrict__ w, float* __restrict__ rootll_part,
    float* __restrict__ logscale_part, float* __restrict__ c1,
    float* __restrict__ c2, int K, int R, int N, int A, int S, int outc) {
  extern __shared__ float smem[];
  const int AA = A * A;
  float* pl = smem;
  float* pr = pl + AA;
  float* pv = pr + AA;
  float* x1 = pv + A;
  float* x2 = x1 + A * kPitch;
  float* wt = x2 + A * kPitch;
  float* sc = wt + A * kPitch;          // kTile per-site scales
  const int k = blockIdx.x, tile = blockIdx.y, T = gridDim.y;
  const int s0 = tile * kTile;
  const size_t slab = (size_t)A * S;
  load_params(pl, pr, pv, Pl, Pr, pi, k, A);
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  load_tile(m1, x1, A, S, s0, c1 ? c1 + (size_t)k * slab : nullptr);
  load_tile(m2, x2, A, S, s0, c2 ? c2 + (size_t)k * slab : nullptr);
  __syncthreads();

  const int s = threadIdx.x & 31, bw = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int b0 = bw; b0 < A; b0 += 4 * nw) {
    float u[4], v[4];
    contract_pair<4>(x1, x2, pl, pr, A, b0, nw, s, u, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + j * nw;
      if (b < A) wt[b * kPitch + s] = __fmul_rn(u[j], v[j]);
    }
  }
  __syncthreads();

  if (threadIdx.x < kTile) {            // warp 0: one lane per site
    float raw = __int_as_float(0xff800000), site = 0.f;  // -inf
    for (int b = 0; b < A; ++b) {
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
  for (int e = threadIdx.x; e < A * kTile; e += blockDim.x) {
    const int a = e / kTile, ss = e - a * kTile, gs = s0 + ss;
    if (gs < S) out[(size_t)a * S + gs] = wt[a * kPitch + ss] / sc[ss];
  }
}

// K9bs (Gather = false, saved children m1g / m2g) and K9b (Gather =
// true, children re-gathered from leaves / buf by idx).  grid (K,), NT
// threads; DPJ = ceil(A^2 / NT) dP accumulators a side per thread.
template <bool Gather, int NT, int DPJ>
__global__ void __launch_bounds__(NT) wide_rank_bwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ leaves, const float* __restrict__ buf,
    const int* __restrict__ idx, const float* __restrict__ gmg,
    const float* __restrict__ gr, const float* __restrict__ gl,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ dm1g, float* __restrict__ dm2g,
    float* __restrict__ dPl, float* __restrict__ dPr,
    float* __restrict__ dpi_part, float* __restrict__ dw_part, int K, int R,
    int N, int A, int S) {
  constexpr int NW = NT / 32;
  extern __shared__ float smem[];
  const int AA = A * A;
  const int tp = A * kPitch;
  float* pl = smem;
  float* pr = pl + AA;
  float* pv = pr + AA;
  float* x1 = pv + A;
  float* x2 = x1 + tp;
  float* g = x2 + tp;                   // cotangent tile, then du
  float* us = g + tp;                   // u, then dv
  float* vs = us + tp;
  float* sinv = vs + tp;                // per-site scalars, kTile each
  float* sdsite = sinv + kTile;
  float* sdraw = sdsite + kTile;
  float* sneq = sdraw + kTile;
  float* sraw = sneq + kTile;
  const int k = blockIdx.x;
  const size_t slab = (size_t)A * S;
  load_params(pl, pr, pv, Pl, Pr, pi, k, A);
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
  const int s = threadIdx.x & 31, bw = threadIdx.x >> 5;

  float dpi_acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) dpi_acc[j] = 0.f;
  float accl[DPJ], accr[DPJ];
#pragma unroll
  for (int j = 0; j < DPJ; ++j) {
    accl[j] = 0.f;
    accr[j] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kTile) {
    __syncthreads();                    // the last tile's readers are done
    load_tile(m1, x1, A, S, s0, nullptr);
    load_tile(m2, x2, A, S, s0, nullptr);
    load_tile(gm, g, A, S, s0, nullptr);
    __syncthreads();

    for (int b0 = bw; b0 < A; b0 += 4 * NW) {
      float u[4], v[4];
      contract_pair<4>(x1, x2, pl, pr, A, b0, NW, s, u, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + j * NW;
        if (b < A) {
          us[b * kPitch + s] = u[j];
          vs[b * kPitch + s] = v[j];
        }
      }
    }
    __syncthreads();

    if (threadIdx.x < kTile) {          // warp 0: one lane per site
      const int gs = s0 + s;
      float raw = __int_as_float(0xff800000);  // -inf
      float neq = 0.f, site = 0.f, gsum = 0.f;
      for (int b = 0; b < A; ++b) {
        const float x = __fmul_rn(us[b * kPitch + s], vs[b * kPitch + s]);
        site = __fmaf_rn(x, pv[b], site);
        gsum = __fmaf_rn(g[b * kPitch + s], x, gsum);
        if (x > raw) {
          raw = x;
          neq = 1.f;
        } else if (x == raw) {
          neq += 1.f;
        }
      }
      const float scale = fmaxf(raw, FLT_MIN);
      float inv = 0.f, dsite = 0.f, draw = 0.f;
      if (gs < S) {                      // padded sites carry no cotangent
        const float ws = w[gs];
        inv = 1.f / scale;
        dsite = (grk * ws) / site;
        const float dscale = (glk * ws) / scale - gsum * (inv * inv);
        // max(raw, tiny): full cotangent above the clamp, half at it
        draw = dscale *
               ((raw > FLT_MIN ? 1.f : 0.f) + (raw == FLT_MIN ? 0.5f : 0.f));
        dw_part[(size_t)k * S + gs] = grk * logf(site) + glk * logf(scale);
      }
      sinv[s] = inv;
      sdsite[s] = dsite;
      sdraw[s] = draw;
      sneq[s] = neq;
      sraw[s] = raw;
    }
    __syncthreads();

    {
      const float inv = sinv[s], dsite = sdsite[s], draw = sdraw[s];
      const float neq = sneq[s], raw = sraw[s];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int b = bw + j * NW;
        if (b < A) {
          const float u = us[b * kPitch + s], v = vs[b * kPitch + s];
          const float wp = __fmul_rn(u, v);
          // reduce-max cotangent split evenly among tied planes
          const float eq = (wp == raw) ? 1.f : 0.f;
          const float dwp =
              g[b * kPitch + s] * inv + dsite * pv[b] + draw * (eq / neq);
          g[b * kPitch + s] = dwp * v;   // du
          us[b * kPitch + s] = dwp * u;  // dv
          dpi_acc[j] += dsite * wp;
        }
      }
    }
    __syncthreads();

    // dm1[a, s] = sum_b P_l[a, b] du[b, s]; dm2 likewise
    const int gs = s0 + s;
    for (int a0 = bw; a0 < A; a0 += 4 * NW) {
      float d1[4], d2[4];
      int aj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        aj[j] = min(a0 + j * NW, A - 1);
        d1[j] = 0.f;
        d2[j] = 0.f;
      }
      for (int b = 0; b < A; ++b) {
        const float y1 = g[b * kPitch + s], y2 = us[b * kPitch + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d1[j] = __fmaf_rn(pl[aj[j] * A + b], y1, d1[j]);
          d2[j] = __fmaf_rn(pr[aj[j] * A + b], y2, d2[j]);
        }
      }
      if (gs < S) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = a0 + j * NW;
          if (a < A) {
            dm1[(size_t)a * S + gs] = d1[j];
            dm2[(size_t)a * S + gs] = d2[j];
          }
        }
      }
    }

    // dP_l[a, b] += sum_s m1[a, s] du[b, s]; dP_r with m2, dv
#pragma unroll
    for (int j = 0; j < DPJ; ++j) {
      const int e = threadIdx.x + j * NT;
      if (e < AA) {
        const int a = e / A, b = e - a * A;
        const float* y1 = x1 + a * kPitch;
        const float* z1 = g + b * kPitch;
        const float* y2 = x2 + a * kPitch;
        const float* z2 = us + b * kPitch;
        float tl = accl[j], tr = accr[j];
#pragma unroll 8
        for (int ss = 0; ss < kTile; ++ss) {
          tl = __fmaf_rn(y1[ss], z1[ss], tl);
          tr = __fmaf_rn(y2[ss], z2[ss], tr);
        }
        accl[j] = tl;
        accr[j] = tr;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < DPJ; ++j) {
    const int e = threadIdx.x + j * NT;
    if (e < AA) {
      dPl[(size_t)k * AA + e] = accl[j];
      dPr[(size_t)k * AA + e] = accr[j];
    }
  }
  // dpi: the warp's lanes hold one site each of the same planes
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const float v = warp_sum(dpi_acc[j]);
    const int b = bw + j * NW;
    if (s == 0 && b < A) dpi_part[(size_t)k * A + b] = v;
  }
}

size_t fwd_smem(int A) {
  return (size_t)(2 * A * A + A + 3 * A * kPitch + kTile) * sizeof(float);
}

size_t bwd_smem(int A) {
  return (size_t)(2 * A * A + A + 5 * A * kPitch + 5 * kTile) * sizeof(float);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool Gather, int NT, int DPJ>
int run_bwd(const float* m1, const float* m2, const float* leaves,
            const float* buf, const int* idx, const float* gm,
            const float* gr, const float* gl, const float* Pl,
            const float* Pr, const float* pi, const float* w, float* dm1,
            float* dm2, float* dPl, float* dPr, float* dpi_part,
            float* dw_part, int K, int R, int N, int A, int S,
            cudaStream_t st) {
  const size_t smem = bwd_smem(A);
  auto kernel = wide_rank_bwd_kernel<Gather, NT, DPJ>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<K, NT, smem, st>>>(m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr,
                              pi, w, dm1, dm2, dPl, dPr, dpi_part, dw_part,
                              K, R, N, A, S);
  return (int)cudaGetLastError();
}

// A <= 64: 256 threads, 16 dP accumulators a side; A <= 128: 512, 32.
template <bool Gather>
int launch_bwd(const float* m1, const float* m2, const float* leaves,
               const float* buf, const int* idx, const float* gm,
               const float* gr, const float* gl, const float* Pl,
               const float* Pr, const float* pi, const float* w, float* dm1,
               float* dm2, float* dPl, float* dPr, float* dpi_part,
               float* dw_part, int K, int R, int N, int A, int S,
               void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (A < 1 || A > kMaxA) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A <= 64)
    return run_bwd<Gather, 256, 16>(m1, m2, leaves, buf, idx, gm, gr, gl,
                                    Pl, Pr, pi, w, dm1, dm2, dPl, dPr,
                                    dpi_part, dw_part, K, R, N, A, S, st);
  return run_bwd<Gather, 512, 32>(m1, m2, leaves, buf, idx, gm, gr, gl, Pl,
                                  Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part,
                                  dw_part, K, R, N, A, S, st);
}

}  // namespace

extern "C" int launch_wide_rank(const float* leaves, float* buf,
                                const int* idx, const float* Pl,
                                const float* Pr, const float* pi,
                                const float* w, float* rootll_part,
                                float* logscale_part, float* c1, float* c2,
                                int K, int R, int N, int A, int S, int outc,
                                void* stream) {
  if (K <= 0 || S <= 0) return 0;
  if (A < 1 || A > kMaxA) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(A);
  const int err = allow_smem(wide_rank_kernel, smem);
  if (err) return err;
  const dim3 grid(K, (S + kTile - 1) / kTile);
  wide_rank_kernel<<<grid, kFwdThreads, smem, st>>>(
      leaves, buf, idx, Pl, Pr, pi, w, rootll_part, logscale_part, c1, c2, K,
      R, N, A, S, outc);
  return (int)cudaGetLastError();
}

extern "C" int launch_wide_rank_bwd_saved(
    const float* m1, const float* m2, const float* gm, const float* gr,
    const float* gl, const float* Pl, const float* Pr, const float* pi,
    const float* w, float* dm1, float* dm2, float* dPl, float* dPr,
    float* dpi_part, float* dw_part, int K, int A, int S, void* stream) {
  return launch_bwd<false>(m1, m2, nullptr, nullptr, nullptr, gm, gr, gl, Pl,
                           Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part, dw_part,
                           K, 0, 0, A, S, stream);
}

extern "C" int launch_wide_rank_bwd(
    const float* leaves, const float* buf, const int* idx, const float* gm,
    const float* gr, const float* gl, const float* Pl, const float* Pr,
    const float* pi, const float* w, float* dm1, float* dm2, float* dPl,
    float* dPr, float* dpi_part, float* dw_part, int K, int R, int N, int A,
    int S, void* stream) {
  return launch_bwd<true>(nullptr, nullptr, leaves, buf, idx, gm, gr, gl, Pl,
                          Pr, pi, w, dm1, dm2, dPl, dPr, dpi_part, dw_part, K,
                          R, N, A, S, stream);
}
