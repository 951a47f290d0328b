// Kernels K7 wide, K11b and K11c of phylo_tpu_torch: the VNCSMC
// pair-loglik forward and its two backwards for messages of up to 64
// dense states (GTR+Gamma4 under twist: 16 planes, +I 20, codons 61).
//
// The function, for M candidate merges of each of KC (particle, pair)
// rows that share their children m1, m2 (KC, A, S):
//
//     u = P_l[m]^T m1,  v = P_r[m]^T m2,  site = sum_b pi_b u_b v_b
//     ll[m, k] = sum_s w_s log site[m, k, s]
//
// K11b replaces phylo_tpu/pruning/kernels.py::fused_pair_loglik, both
// of its Pallas sites: _pair_ll_forward (body _kernel_ll, grid (K-tile,
// site-tile, M)) and _pair_ll_forward2 (body _kernel_ll_fwd2, M looped
// inside the program), which compute the same (M, KC) log-likelihoods.
// K7 wide replaces ::_pair_ll_bwd_pallas's body _kernel_ll_bwd above
// A = 8 (twist_kernels.cu holds K7 for A <= 8): given g[m, k] = d loss /
// d ll[m, k], dm1, dm2 (KC, A, S) summed over m and dP_l, dP_r (M, KC,
// A, A) summed over sites.  K11c replaces the same function's T-field
// body _kernel_ll_bwd2 (PHYLO_TWIST_BWD_V2): dm1, dm2 through
// vbar_a = sum_b P_l[a, b] pi_b v_b and ubar likewise, and the bilinear
// form T[m, k, a, a'] = sum_s gsite m1[a] m2[a'] in place of dP, from
// which the wrapper forms dP_l = (T P_r) pi and dP_r = (T^T P_l) pi.
// dpi and dw stay in the wrapper, as in the JAX package.
//
// What bounds them on an H100.  Per (m, k, s) the forward does 2 A^2
// FMAs (A = 16: 512) against 2 A message floats shared by all M, and
// the backwards about 6 A^2: all three sit above the card's FP32 ridge
// (20 FLOP/B) for A >= 4 at M = 10, so operations bound them.  All
// arithmetic is FP32 FMAs on the CUDA cores in a fixed order (no tensor
// cores, no TF32); every u and v is one FMA chain, a ascending from 0.
//
// Design.
// * K11b: one block of 128 threads per (row k, tile of 128 sites); a
//   thread owns one site and holds its 2 A message values in registers
//   (templated on AC = 4, 8, 16, 32, 64 >= A, guarded loops); the M
//   subsamples loop inside the block, so a message is read from memory
//   once for all M (the _kernel_ll_fwd2 idea).  P_l[m, k], P_r[m, k]
//   pass through shared memory, read as broadcasts.  Each m's site sum
//   is a block reduction in a fixed order into one partial per (m, k,
//   tile), which the wrapper sums with torch.sum (no atomics).
// * K7 wide / K11c (one body, `TField`): one block of 256 threads per
//   row k looping over tiles of 32 sites, the M subsamples inside, as
//   _kernel_ll_bwd's fori_loop: the message tile (A x 32, pitch 33
//   floats, no bank conflicts) is staged once for all M.  Per m:
//   P_l, P_r into shared memory; u, v (a warp owns planes, a lane a
//   site); warp 0's gsite = g w / site; du, dv (or pi u, pi v) in place;
//   the dm accumulators stay in registers across all M; and the 2 A^2
//   dP sums (A^2 T sums) over the tile's 32 sites, each added by its
//   owning thread onto the earlier tiles' total in global memory (the
//   block owns that row, so the order is fixed and nothing races).  The
//   narrow K7 kept dP in registers; at A = 16 that is 512 floats a
//   thread, hence the tile form here.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxA = 64;
constexpr int kFwdThreads = 128;   // K11b: sites per block
constexpr int kBwdThreads = 256;   // K7 wide / K11c
constexpr int kWarps = kBwdThreads / 32;
constexpr int kTile = 32;          // backward: sites per tile
constexpr int kPitch = kTile + 1;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// K11b.  grid (KC, T), T = ceil(S / kFwdThreads); part (M, KC, T).
template <int AC>
__global__ void __launch_bounds__(kFwdThreads) pair_ll_fwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ part, int KC, int M, int A, int S) {
  extern __shared__ float smem[];
  const int AA = A * A;
  float* pl = smem;
  float* pr = pl + AA;
  float* pv = pr + AA;
  float* red = pv + A;                 // one partial per warp
  const int k = blockIdx.x, tile = blockIdx.y, T = gridDim.y;
  const int s = tile * kFwdThreads + threadIdx.x;
  const bool ok = s < S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float a1[AC], a2[AC];
#pragma unroll
  for (int a = 0; a < AC; ++a) {
    a1[a] = (a < A && ok) ? m1[(size_t)a * S + s] : 0.f;
    a2[a] = (a < A && ok) ? m2[(size_t)a * S + s] : 0.f;
  }
  const float ws = ok ? w[s] : 0.f;
  for (int c = threadIdx.x; c < A; c += blockDim.x) pv[c] = pi[c];

  for (int m = 0; m < M; ++m) {
    const size_t row = (size_t)m * KC + k;
    __syncthreads();                   // the last m's readers are done
    for (int c = threadIdx.x; c < AA; c += blockDim.x) {
      pl[c] = Pl[row * AA + c];
      pr[c] = Pr[row * AA + c];
    }
    __syncthreads();
    float site = 0.f;
    for (int b = 0; b < A; ++b) {
      float u = 0.f, v = 0.f;
#pragma unroll
      for (int a = 0; a < AC; ++a) {
        if (a < A) {
          u = __fmaf_rn(a1[a], pl[a * A + b], u);
          v = __fmaf_rn(a2[a], pr[a * A + b], v);
        }
      }
      site = __fmaf_rn(__fmul_rn(u, v), pv[b], site);
    }
    float x = ok ? logf(site) * ws : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[warp] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int i = 0; i < kFwdThreads / 32; ++i) t += red[i];
      part[row * T + tile] = t;
    }
  }
}

// K7 wide (TField = false) and K11c (TField = true).  grid (KC,); NJ =
// ceil(A / kWarps) planes a thread owns; out_l / out_r are dP_l / dP_r
// (M, KC, A, A), or T and nothing.
template <bool TField, int NJ>
__global__ void __launch_bounds__(kBwdThreads) pair_ll_bwd_tile_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ dm1g,
    float* __restrict__ dm2g, float* __restrict__ out_l,
    float* __restrict__ out_r, int KC, int M, int A, int S) {
  extern __shared__ float smem[];
  const int AA = A * A, tp = A * kPitch;
  float* pl = smem;
  float* pr = pl + AA;
  float* pv = pr + AA;
  float* x1 = pv + A;
  float* x2 = x1 + tp;
  float* us = x2 + tp;                 // u, then du (K7) or pi u (K11c)
  float* vs = us + tp;                 // v, then dv (K7) or pi v (K11c)
  float* gsh = vs + tp;                // kTile gsite values
  float* wsh = gsh + kTile;            // kTile site weights
  const int k = blockIdx.x;
  const int s = threadIdx.x & 31, bw = threadIdx.x >> 5;
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;
  for (int c = threadIdx.x; c < A; c += blockDim.x) pv[c] = pi[c];

  for (int s0 = 0; s0 < S; s0 += kTile) {
    __syncthreads();                   // the last tile's readers are done
    for (int e = threadIdx.x; e < A * kTile; e += blockDim.x) {
      const int a = e / kTile, ss = e - a * kTile, gs = s0 + ss;
      const bool in = gs < S;
      x1[a * kPitch + ss] = in ? m1[(size_t)a * S + gs] : 0.f;
      x2[a * kPitch + ss] = in ? m2[(size_t)a * S + gs] : 0.f;
    }
    if (threadIdx.x < kTile)
      wsh[threadIdx.x] = s0 + threadIdx.x < S ? w[s0 + threadIdx.x] : 0.f;
    float d1[NJ], d2[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      d1[j] = 0.f;
      d2[j] = 0.f;
    }

    for (int m = 0; m < M; ++m) {
      const size_t row = (size_t)m * KC + k;
      __syncthreads();                 // the last m's readers are done
      for (int c = threadIdx.x; c < AA; c += blockDim.x) {
        pl[c] = Pl[row * AA + c];
        pr[c] = Pr[row * AA + c];
      }
      __syncthreads();

      // u[b, s], v[b, s]: one FMA chain each, a ascending
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int b = bw + j * kWarps;
        if (b < A) {
          float u = 0.f, v = 0.f;
          for (int a = 0; a < A; ++a) {
            u = __fmaf_rn(x1[a * kPitch + s], pl[a * A + b], u);
            v = __fmaf_rn(x2[a * kPitch + s], pr[a * A + b], v);
          }
          us[b * kPitch + s] = u;
          vs[b * kPitch + s] = v;
        }
      }
      __syncthreads();

      if (threadIdx.x < kTile) {       // warp 0: one lane per site
        float site = 0.f;
        for (int b = 0; b < A; ++b)
          site = __fmaf_rn(__fmul_rn(us[b * kPitch + s], vs[b * kPitch + s]),
                           pv[b], site);
        // padded sites have weight 0, so gsite = 0 and add nothing
        gsh[s] = s0 + s < S ? (__ldg(g + row) * wsh[s]) / site : 0.f;
      }
      __syncthreads();

      const float gsite = gsh[s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int b = bw + j * kWarps;
        if (b < A) {
          const float u = us[b * kPitch + s], v = vs[b * kPitch + s];
          if (TField) {
            us[b * kPitch + s] = u * pv[b];
            vs[b * kPitch + s] = v * pv[b];
          } else {
            us[b * kPitch + s] = gsite * (v * pv[b]);   // du
            vs[b * kPitch + s] = gsite * (u * pv[b]);   // dv
          }
        }
      }
      __syncthreads();

      // dm1[a, s] += sum_b P_l[a, b] du[b, s] (K7), or gsite * sum_b
      // P_l[a, b] pi_b v[b, s] (K11c); dm2 mirrored
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int a = bw + j * kWarps;
        if (a < A) {
          const float* pla = pl + a * A;
          const float* pra = pr + a * A;
          if (TField) {
            float vbar = 0.f, ubar = 0.f;
            for (int b = 0; b < A; ++b) {
              vbar = __fmaf_rn(pla[b], vs[b * kPitch + s], vbar);
              ubar = __fmaf_rn(pra[b], us[b * kPitch + s], ubar);
            }
            d1[j] = __fmaf_rn(gsite, vbar, d1[j]);
            d2[j] = __fmaf_rn(gsite, ubar, d2[j]);
          } else {
            float t1 = d1[j], t2 = d2[j];
            for (int b = 0; b < A; ++b) {
              t1 = __fmaf_rn(us[b * kPitch + s], pla[b], t1);
              t2 = __fmaf_rn(vs[b * kPitch + s], pra[b], t2);
            }
            d1[j] = t1;
            d2[j] = t2;
          }
        }
      }

      // dP_l[a, b] = sum_s m1[a, s] du[b, s], dP_r with m2, dv (K7), or
      // T[a, a'] = sum_s gsite m1[a, s] m2[a', s] (K11c), over this tile,
      // onto the earlier tiles' total
      for (int e = threadIdx.x; e < AA; e += blockDim.x) {
        const int a = e / A, b = e - a * A;
        const float* y1 = x1 + a * kPitch;
        float* o = out_l + row * AA + e;
        if (TField) {
          const float* z2 = x2 + b * kPitch;
          float t = 0.f;
#pragma unroll 8
          for (int ss = 0; ss < kTile; ++ss)
            t = __fmaf_rn(gsh[ss] * y1[ss], z2[ss], t);
          *o = s0 ? *o + t : t;
        } else {
          const float* z1 = us + b * kPitch;
          const float* y2 = x2 + a * kPitch;
          const float* z2 = vs + b * kPitch;
          float tl = 0.f, tr = 0.f;
#pragma unroll 8
          for (int ss = 0; ss < kTile; ++ss) {
            tl = __fmaf_rn(y1[ss], z1[ss], tl);
            tr = __fmaf_rn(y2[ss], z2[ss], tr);
          }
          float* orr = out_r + row * AA + e;
          *o = s0 ? *o + tl : tl;
          *orr = s0 ? *orr + tr : tr;
        }
      }
    }

    const int gs = s0 + s;
    if (gs < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int a = bw + j * kWarps;
        if (a < A) {
          dm1[(size_t)a * S + gs] = d1[j];
          dm2[(size_t)a * S + gs] = d2[j];
        }
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int AC>
int run_fwd(const float* m1, const float* m2, const float* Pl,
            const float* Pr, const float* pi, const float* w, float* part,
            int KC, int M, int A, int S, cudaStream_t st) {
  const size_t smem = (size_t)(2 * A * A + A + 32) * sizeof(float);
  auto kernel = pair_ll_fwd_kernel<AC>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(KC, (S + kFwdThreads - 1) / kFwdThreads);
  kernel<<<grid, kFwdThreads, smem, st>>>(m1, m2, Pl, Pr, pi, w, part, KC, M,
                                          A, S);
  return (int)cudaGetLastError();
}

template <bool TField, int NJ>
int run_bwd(const float* m1, const float* m2, const float* Pl,
            const float* Pr, const float* pi, const float* w, const float* g,
            float* dm1, float* dm2, float* out_l, float* out_r, int KC,
            int M, int A, int S, cudaStream_t st) {
  const size_t smem =
      (size_t)(2 * A * A + A + 4 * A * kPitch + 2 * kTile) * sizeof(float);
  auto kernel = pair_ll_bwd_tile_kernel<TField, NJ>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<KC, kBwdThreads, smem, st>>>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2,
                                        out_l, out_r, KC, M, A, S);
  return (int)cudaGetLastError();
}

template <bool TField>
int launch_bwd(const float* m1, const float* m2, const float* Pl,
               const float* Pr, const float* pi, const float* w,
               const float* g, float* dm1, float* dm2, float* out_l,
               float* out_r, int KC, int M, int A, int S, void* stream) {
  if (KC <= 0) return 0;
  if (M < 0 || S <= 0 || A < 1 || A > kMaxA)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A <= kWarps)
    return run_bwd<TField, 1>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, out_l,
                              out_r, KC, M, A, S, st);
  if (A <= 2 * kWarps)
    return run_bwd<TField, 2>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, out_l,
                              out_r, KC, M, A, S, st);
  if (A <= 4 * kWarps)
    return run_bwd<TField, 4>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, out_l,
                              out_r, KC, M, A, S, st);
  return run_bwd<TField, 8>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, out_l,
                            out_r, KC, M, A, S, st);
}

}  // namespace

extern "C" int launch_pair_ll_fwd(const float* m1, const float* m2,
                                  const float* Pl, const float* Pr,
                                  const float* pi, const float* w,
                                  float* part, int KC, int M, int A, int S,
                                  void* stream) {
  if (KC <= 0 || M <= 0) return 0;
  if (S <= 0 || A < 1 || A > kMaxA) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A <= 4) return run_fwd<4>(m1, m2, Pl, Pr, pi, w, part, KC, M, A, S, st);
  if (A <= 8) return run_fwd<8>(m1, m2, Pl, Pr, pi, w, part, KC, M, A, S, st);
  if (A <= 16)
    return run_fwd<16>(m1, m2, Pl, Pr, pi, w, part, KC, M, A, S, st);
  if (A <= 32)
    return run_fwd<32>(m1, m2, Pl, Pr, pi, w, part, KC, M, A, S, st);
  return run_fwd<64>(m1, m2, Pl, Pr, pi, w, part, KC, M, A, S, st);
}

extern "C" int launch_pair_ll_bwd_wide(const float* m1, const float* m2,
                                       const float* Pl, const float* Pr,
                                       const float* pi, const float* w,
                                       const float* g, float* dm1,
                                       float* dm2, float* dPl, float* dPr,
                                       int KC, int M, int A, int S,
                                       void* stream) {
  return launch_bwd<false>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC,
                           M, A, S, stream);
}

extern "C" int launch_pair_ll_bwd_t(const float* m1, const float* m2,
                                    const float* Pl, const float* Pr,
                                    const float* pi, const float* w,
                                    const float* g, float* dm1, float* dm2,
                                    float* T, int KC, int M, int A, int S,
                                    void* stream) {
  return launch_bwd<true>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, T, nullptr, KC,
                          M, A, S, stream);
}
