// Kernels K7 and K8 of phylo_tpu_torch: the VNCSMC pair-loglik backward
// and the merge on explicit children.
//
// K7 replaces phylo_tpu/pruning/kernels.py::_pair_ll_bwd_pallas (body
// _kernel_ll_bwd): the cotangents of M candidate merges per particle,
//
//     u = P_l[m]^T m1,  v = P_r[m]^T m2,  site = sum_b pi_b u_b v_b
//     ll[m, k] = sum_s w_s log site[m, k, s]
//
// given g[m, k] = d loss / d ll[m, k]: dm1, dm2 (KC, A, S) summed over m,
// and dP_l, dP_r (M, KC, A, A) summed over sites.  dpi and dw stay in
// the wrapper, as in the JAX package.
//
// K8 replaces ::fused_merge_loglik (body _kernel via _pallas_forward):
// K1's merge, rescale and root log-lik on children given explicitly,
// writing the merged message to its own output.
//
// Layout as in rank_kernels.cu: states-major (A, S) slabs contiguous in
// S, transitions (.., A, A) row-major with u[b] = sum_a m[a] P[a, b].
//
// What bounds them on an H100.  K8: bytes (two children in, one merged
// message out, ~4 A^2 FMAs per site).  K7: operations -- per (m, k, s)
// it recomputes u and v (2 A^2 FMAs), then forms du, dv and both the dm
// and dP terms (4 A^2 FMAs more), M times over the same children, so at
// M=10 it does ~60 A^2 FMAs per site for 4A floats read and 2A written.
//
// Design.  One CUDA block per particle, threads over sites, exact FP32
// FMAs in registers (no tensor cores, no TF32).  The TPU carried the
// site sums of K8 (rootll, logscale) and of K7 (dP) across a sequential
// grid axis; blocks run in parallel here, so one block owns every site
// of its particle and reduces them itself, in a fixed order (no
// atomics).  K7 keeps kSitesPerThread sites of each thread in registers
// (children, weights and the dm accumulators) and loops over all M
// subsamples inside the block, as the TPU's fori_loop did: dm never
// leaves registers until it is complete, and each m's dP is one block
// reduction added by thread 0 onto the previous site tile's partial.
// M is looped whole at any size (the TPU chunked it at 64 for VMEM; the
// loop here keeps nothing per m).  Ragged site tiles are masked, not
// padded.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 128;
constexpr int kSitesPerThread = 2;

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

template <int A>
__global__ void __launch_bounds__(kThreads) merge_loglik_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ merged, float* __restrict__ rootll,
    float* __restrict__ logscale, int S) {
  __shared__ float sh[32 * 2];
  const int k = blockIdx.x;
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* out = merged + (size_t)k * slab;
  float pl[A * A], pr[A * A], pv[A];
#pragma unroll
  for (int c = 0; c < A * A; ++c) {
    pl[c] = Pl[(size_t)k * A * A + c];
    pr[c] = Pr[(size_t)k * A * A + c];
  }
#pragma unroll
  for (int a = 0; a < A; ++a) pv[a] = pi[a];

  float acc[2] = {0.f, 0.f};
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float a1[A], a2[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      a1[a] = m1[(size_t)a * S + s];
      a2[a] = m2[(size_t)a * S + s];
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

template <int A>
__global__ void __launch_bounds__(kThreads) pair_ll_bwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ dm1g,
    float* __restrict__ dm2g, float* __restrict__ dPl,
    float* __restrict__ dPr, int KC, int M, int S) {
  constexpr int AA = A * A;
  constexpr int NP = 2 * AA;
  constexpr int SPT = kSitesPerThread;
  __shared__ float sh[32 * NP];
  const int k = blockIdx.x;
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;
  float pv[A];
#pragma unroll
  for (int a = 0; a < A; ++a) pv[a] = pi[a];
  const int tile = blockDim.x * SPT;

  for (int t0 = 0; t0 < S; t0 += tile) {
    float a1[SPT][A], a2[SPT][A], d1[SPT][A], d2[SPT][A], ws[SPT];
    bool ok[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int s = t0 + j * blockDim.x + threadIdx.x;
      ok[j] = s < S;
      ws[j] = ok[j] ? w[s] : 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        a1[j][a] = ok[j] ? m1[(size_t)a * S + s] : 0.f;
        a2[j][a] = ok[j] ? m2[(size_t)a * S + s] : 0.f;
        d1[j][a] = 0.f;
        d2[j][a] = 0.f;
      }
    }
    for (int m = 0; m < M; ++m) {
      const size_t row = (size_t)m * KC + k;
      float pl[AA], pr[AA];
#pragma unroll
      for (int c = 0; c < AA; ++c) {
        pl[c] = __ldg(Pl + row * AA + c);
        pr[c] = __ldg(Pr + row * AA + c);
      }
      const float gk = __ldg(g + row);
      float dP[NP];
#pragma unroll
      for (int c = 0; c < NP; ++c) dP[c] = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        if (!ok[j]) continue;
        float u[A], v[A];
        float site = 0.f;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          float uu = a1[j][0] * pl[b], vv = a2[j][0] * pr[b];
#pragma unroll
          for (int a = 1; a < A; ++a) {
            uu += a1[j][a] * pl[a * A + b];
            vv += a2[j][a] * pr[a * A + b];
          }
          u[b] = uu;
          v[b] = vv;
          site = b ? site + (uu * vv) * pv[b] : (uu * vv) * pv[b];
        }
        const float gsite = (gk * ws[j]) / site;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const float du = gsite * (v[b] * pv[b]);
          const float dv = gsite * (u[b] * pv[b]);
#pragma unroll
          for (int a = 0; a < A; ++a) {
            d1[j][a] += du * pl[a * A + b];
            d2[j][a] += dv * pr[a * A + b];
            dP[a * A + b] += du * a1[j][a];
            dP[AA + a * A + b] += dv * a2[j][a];
          }
        }
      }
      block_sum<NP>(dP, sh);
      if (threadIdx.x == 0) {
        float* ol = dPl + row * AA;
        float* orr = dPr + row * AA;
#pragma unroll
        for (int c = 0; c < AA; ++c) {
          ol[c] = t0 ? ol[c] + dP[c] : dP[c];
          orr[c] = t0 ? orr[c] + dP[AA + c] : dP[AA + c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (!ok[j]) continue;
      const int s = t0 + j * blockDim.x + threadIdx.x;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        dm1[(size_t)a * S + s] = d1[j][a];
        dm2[(size_t)a * S + s] = d2[j][a];
      }
    }
  }
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

extern "C" int launch_merge_loglik(const float* m1, const float* m2,
                                   const float* Pl, const float* Pr,
                                   const float* pi, const float* w,
                                   float* merged, float* rootll,
                                   float* logscale, int K, int A, int S,
                                   void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_K8(AA)                                                       \
  case AA:                                                                 \
    merge_loglik_kernel<AA><<<K, kThreads, 0, st>>>(                       \
        m1, m2, Pl, Pr, pi, w, merged, rootll, logscale, S);               \
    break;
    PHYLO_A_CASES(PHYLO_K8)
#undef PHYLO_K8
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_pair_ll_bwd(const float* m1, const float* m2,
                                  const float* Pl, const float* Pr,
                                  const float* pi, const float* w,
                                  const float* g, float* dm1, float* dm2,
                                  float* dPl, float* dPr, int KC, int M,
                                  int A, int S, void* stream) {
  if (KC <= 0) return 0;
  if (M < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_K7(AA)                                                       \
  case AA:                                                                 \
    pair_ll_bwd_kernel<AA><<<KC, kThreads, 0, st>>>(                       \
        m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, S);          \
    break;
    PHYLO_A_CASES(PHYLO_K7)
#undef PHYLO_K7
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
