// Kernels K11b, K7 wide and K11c of phylo_tpu_torch: the VNCSMC
// pair-loglik forward and its two backwards for messages of up to 64
// planes, dense (GTR+Gamma4 as 16 dense states, codons 61) or blocked
// (a rate mixture's G per-category blocks of A_b states: GTR+Gamma4 is
// G = 4 blocks of 4, +I G = 5).
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
// (PHYLO_TWIST_BWD_V2, dense only; twist_kernels.cu holds it at A <= 8):
// the same dm1, dm2, and dP through the bilinear form T[m, k, a, a'] =
// sum_s gsite m1[a] m2[a'] (gsite = g w / site): dP_l = (T P_r) pi and
// dP_r = (T^T P_l) pi.  The JAX package forms dP from T outside its
// kernel; here the kernel does, and returns dP as K7 wide does.  dpi and
// dw stay in the wrapper, as in the JAX package.
//
// What bounds them on an H100.  Per (m, k, s) the forward does
// 2 A^2 / G FMAs (DS1 GTR+Gamma4 blocked: 128, dense 512) against 2 G A_b
// message floats read once for all M; K7 about 6 A^2 / G.  At M = 10 both
// sit near or above the card's FP32 ridge (20 FLOP/B), so operations
// bound them, with bytes close behind for the blocked forward (DS1 rank
// 0, M = 10, S = 256: K11b blocked 0.131 ms by operations, 0.127 by
// bytes; dense 0.461; K7 wide blocked at 896 rows 0.030, dense 0.109).  All arithmetic is FP32
// FMAs on the CUDA cores in a fixed order (no tensor cores, no TF32:
// ROADMAP's numerics rule, and a 4 x 4 block is far below an mma tile).
// What held PR 6's bodies back was shared memory: one broadcast load per
// FMA (K11b), two operands per FMA plus a global read-modify-write of
// every dP partial per (m, 32-site tile) and five barriers per (m, tile)
// (K7 wide and K11c); and the zero off-block terms, 3/4 of a GTR+Gamma4
// twist's FMAs.
//
// Design.
// * K11b: one block per (row k, site tile); each thread owns SPT = 2
//   consecutive sites (1 above 32 padded planes) and holds their 2 G A_b
//   message values in registers for all M, loaded as one float2 per
//   plane.  P_l[m, k], P_r[m, k] come into shared memory by cp.async,
//   double-buffered across m (m + 1 lands while m computes), rows at
//   pitch AB >= A_b; a thread reads a row's four b-values with one float4
//   broadcast load, which feeds 4 SPT FMAs a side.  Each u_b, v_b is one
//   FMA chain, a ascending from the block's first plane (PR 6's chains,
//   so the dense form gives PR 6's site values).  At S = 256 a block of
//   128 threads covers the whole row, so P is read once per (m, row).
//   Each m's site sum is a warp sum and a fixed-order sum of the warps'
//   partials (double-buffered by the parity of m: one barrier per m) into
//   one partial per (m, k, tile), which the wrapper sums with torch.sum
//   (no atomics).  Templated on (AB, NG): padded block states and blocks,
//   so the message registers are indexed at compile time; the runtime
//   G <= NG, A_b <= AB are guarded, and up to 16 planes an EXACT instance
//   folds the guards away (1.4x at DS1; tools/torch_twist_forms.py).
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
// * K11c (8 < A <= 64, dense): K7 wide's body at G = 1 in its T-field
//   form.  Phases A and B are K7 wide's; phase C sums the NPG^2 (4 x 4)
//   tiles of T over the chunk (half of K7 wide's 2 NPG^2 dP tiles) from
//   the chunk's m1, m2 and gsite in shared memory and stages T there;
//   after a fourth barrier, phase D forms each dP entry from T and the
//   staged P (A FMAs, then pi_b) and writes it once per (m, row), or
//   adds it in chunk order above SC sites.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxPlanes = 64;        // G * A_b planes of every kernel here
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
// the guards fold away and the b0 loop unrolls at compile time.
template <int AB, int NG, int SPT, bool EXACT>
__global__ void __launch_bounds__(kFwdMaxThreads) pair_ll_fwd_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ part, int KC, int M, int G_, int Ab_, int S,
    bool vecP, bool vecM) {
  constexpr int PM = NG * AB * AB;     // one P in shared memory
  constexpr int kUnrollB = EXACT ? AB / 4 : 1;
  extern __shared__ __align__(16) float smem[];
  float* pbuf = smem;                  // [buffer][side][PM]
  float* pv = pbuf + 4 * PM;           // pi (G * Ab planes)
  float* red = pv + NG * AB;           // [parity of m][warp]
  const int G = EXACT ? NG : G_, Ab = EXACT ? AB : Ab_;
  const int GA = G * Ab, BB = GA * Ab;
  const int k = blockIdx.x, tile = blockIdx.y, T = gridDim.y;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = (tile * nthr + threadIdx.x) * SPT;

  for (int c = threadIdx.x; c < 4 * PM; c += nthr) pbuf[c] = 0.f;
  for (int c = threadIdx.x; c < GA; c += nthr) pv[c] = pi[c];
  float x1[NG][AB][SPT], x2[NG][AB][SPT];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int a = 0; a < AB; ++a) {
      if (g < G && a < Ab) {
        const size_t off = ((size_t)k * GA + g * Ab + a) * S;
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
  float ws[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) ws[j] = s0 + j < S ? __ldg(w + s0 + j) : 0.f;
  __syncthreads();                     // the zero fill before the copies
  stage_fwd<AB>(pbuf, pbuf + PM, Pl + (size_t)k * BB, Pr + (size_t)k * BB,
                G, Ab, vecP);

  for (int m = 0; m < M; ++m) {
    cp_async_wait_all();
    __syncthreads();                   // P(m) landed; m - 1 is done
    if (m + 1 < M) {                   // into the buffer m - 1 read
      const size_t row = (size_t)(m + 1) * KC + k;
      float* d = pbuf + 2 * ((m + 1) & 1) * PM;
      stage_fwd<AB>(d, d + PM, Pl + row * BB, Pr + row * BB, G, Ab, vecP);
    }
    if (m > 0 && threadIdx.x == 0) {
      const float* r = red + ((m - 1) & 1) * kFwdMaxWarps;
      float t = 0.f;
      for (int i = 0; i < nwarps; ++i) t += r[i];
      part[((size_t)(m - 1) * KC + k) * T + tile] = t;
    }
    const float* pl = pbuf + 2 * (m & 1) * PM;
    const float* pr = pl + PM;
    float site[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) site[j] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g < G) {
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
                const float p = pv[g * Ab + b0 + i];
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
    float x = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (s0 + j < S) x += logf(site[j]) * ws[j];
    x = warp_sum(x);
    if (lane == 0) red[(m & 1) * kFwdMaxWarps + warp] = x;
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

// grid (KC,), blockDim.x >= NGT * SC / 4; dPl, dPr (M, KC, G, Ab, Ab).
// FIXED_AB: Ab as a compile-time constant (4: DNA blocks; 16: dense
// GTR+Gamma4), or 0 for any Ab at run time.  TF: the T-field form
// (K11c; G = 1), which also stages T (A x ABP) after pi.
template <int FIXED_AB, bool TF>
__device__ __forceinline__ void bwd_wide_body(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    const float* __restrict__ gg, float* __restrict__ dm1g,
    float* __restrict__ dm2g, float* __restrict__ dPl,
    float* __restrict__ dPr, int KC, int M, int G, int Ab_, int S, int SC,
    bool vecM) {
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
  // phase C: TC (side, block, a-group, b-group) tiles, KS threads each;
  // K11c: (a-group, a'-group) tiles of T
  const int TC = (TF ? 1 : 2 * G) * NPG * NPG;
  int KS = 1;
  while (KS < kBwdMaxKS && 2 * KS * TC <= nthr) KS *= 2;
  const int kl = t & (KS - 1), tstride = nthr / KS;
  const size_t slab = (size_t)GA * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;

  for (int c = t; c < 8 * PM; c += nthr) pb[c] = 0.f;
  for (int c = t; c < GA; c += nthr) pis[c] = pi[c];

  for (int s0 = 0; s0 < S; s0 += SC) {
    __syncthreads();                   // the last chunk's readers are done
    for (int e = t; e < GA * SG; e += nthr) {
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

      // (A) u, v of planes g Ab + c0 + i at sites js + j
      if (item) {
        float u[4][4], v[4][4];
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
        float part4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c0 + i < Ab) {
            const int r = g * Ab + c0 + i;
            const float p = pis[r];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part4[j] = __fmaf_rn(__fmul_rn(u[i][j], v[i][j]), p, part4[j]);
            sts4(pvs + r * SCP + js, v[i][0] * p, v[i][1] * p, v[i][2] * p,
                 v[i][3] * p);
            sts4(pus + r * SCP + js, u[i][0] * p, u[i][1] * p, u[i][2] * p,
                 u[i][3] * p);
          }
        }
        sts4(sp + q * SCP + js, part4[0], part4[1], part4[2], part4[3]);
      }
      __syncthreads();                 // (2)

      // (B) gsite, then dm1[a] += sum_b P_l[a, b] du_b with du = gsite
      // (pi v), dm2 with P_r and dv = gsite (pi u), for a = c0 + i
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
#pragma unroll 4
        for (int b = 0; b < Ab; ++b) {
          const int r = g * Ab + b;
          const float4 e = lds4(pvs + r * SCP + js);
          const float4 f = lds4(pus + r * SCP + js);
          const float4 du = make_float4(gsj[0] * e.x, gsj[1] * e.y,
                                        gsj[2] * e.z, gsj[3] * e.w);
          const float4 dv = make_float4(gsj[0] * f.x, gsj[1] * f.y,
                                        gsj[2] * f.z, gsj[3] * f.w);
          fma_quad(d1, du, lds4(ptl + r * ABP + c0));
          fma_quad(d2, dv, lds4(ptr_ + r * ABP + c0));
        }
      }
      __syncthreads();                 // (3) gsite visible

      // (C) dP_l[a, b] = sum_s m1[a] du_b, dP_r[a, b] = sum_s m2[a] dv_b
      // over the chunk, one (4 x 4) tile per KS threads; K11c: T[a, a'] =
      // sum_s m1[a] (gsite m2[a']) into shared memory
      for (int base = 0; base < TC; base += tstride) {
        const int tile = base + t / KS;
        const bool live = tile < TC;
        int r0 = tile;
        const int tb = r0 % NPG;
        r0 /= NPG;
        const int ta = r0 % NPG;
        r0 /= NPG;
        const int tg = r0 % G, side = r0 / G;
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
                tsm[(4 * ta + ia) * ABP + 4 * tb + jb] = acc[ia][jb];
          }
        } else if (live && kl == 0) {
          float* out = (side ? dPr : dPl) + row * BB + (size_t)tg * Ab * Ab
                       + (4 * ta) * Ab + 4 * tb;
#pragma unroll
          for (int ia = 0; ia < 4; ++ia) {
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
              if (ia < na && jb < nb) {
                float* o = out + ia * Ab + jb;
                *o = s0 ? *o + acc[ia][jb] : acc[ia][jb];
              }
            }
          }
        }
      }
      if constexpr (TF) {
        __syncthreads();               // (4) T staged
        // (D) dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b], dP_r[a', b] =
        // pi_b sum_a T[a, a'] P_l[a, b]: chains over a' (a) ascending
        for (int e = t; e < 2 * BB; e += nthr) {
          const int side = e >= BB, c = side ? e - BB : e;
          const int a = c / Ab, b = c - a * Ab;
          float x;
          if (side) {                  // a is a'
            x = __fmul_rn(tsm[a], psl[b]);
            for (int i = 1; i < Ab; ++i)
              x = __fmaf_rn(tsm[i * ABP + a], psl[i * ABP + b], x);
          } else {
            x = __fmul_rn(tsm[a * ABP], psr[b]);
            for (int i = 1; i < Ab; ++i)
              x = __fmaf_rn(tsm[a * ABP + i], psr[i * ABP + b], x);
          }
          x = __fmul_rn(x, pis[b]);
          float* o = (side ? dPr : dPl) + row * BB + c;
          *o = s0 ? *o + x : x;
        }
      }
    }

    if (item) {
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
  }
}

#define PHYLO_BWD_ARGS                                                     \
  const float *__restrict__ m1g, const float *__restrict__ m2g,            \
      const float *__restrict__ Pl, const float *__restrict__ Pr,          \
      const float *__restrict__ pi, const float *__restrict__ w,           \
      const float *__restrict__ gg, float *__restrict__ dm1g,              \
      float *__restrict__ dm2g, float *__restrict__ dPl,                   \
      float *__restrict__ dPr, int KC, int M, int G, int Ab_, int S,       \
      int SC, bool vecM
#define PHYLO_BWD_CALL                                                     \
  m1g, m2g, Pl, Pr, pi, w, gg, dm1g, dm2g, dPl, dPr, KC, M, G, Ab_, S, SC, \
      vecM

// K7 wide
template <int FIXED_AB>
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_wide_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_body<FIXED_AB, false>(PHYLO_BWD_CALL);
}

// K11c above 8 states: K7 wide's body in its T-field form (G = 1)
template <int FIXED_AB>
__global__ void __launch_bounds__(kBwdMaxThreads)
    pair_ll_bwd_t_wide_kernel(PHYLO_BWD_ARGS) {
  bwd_wide_body<FIXED_AB, true>(PHYLO_BWD_CALL);
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

template <int AB, int NG, int SPT, bool EXACT>
int launch_fwd(const float* m1, const float* m2, const float* Pl,
               const float* Pr, const float* pi, const float* w, float* part,
               int KC, int M, int G, int Ab, int S, int threads, int tiles,
               cudaStream_t st) {
  const size_t smem =
      (size_t)(4 * AB * AB * NG + AB * NG + 2 * kFwdMaxWarps) * sizeof(float);
  auto kernel = pair_ll_fwd_kernel<AB, NG, SPT, EXACT>;
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
            cudaStream_t st) {
  if (threads < 32 || threads > kFwdMaxThreads || threads % 32 ||
      tiles < 1 || tiles > 65535 || (long long)tiles * threads * SPT < S)
    return (int)cudaErrorInvalidValue;
  // up to 16 planes (primate, DS1 dense and GTR+Gamma4's blocks) an
  // instance with the shape folded in, about 1.4x quicker; wider
  // shapes share the guarded one (compile time)
  if constexpr (AB * NG <= 16) {
    if (G == NG && Ab == AB)
      return launch_fwd<AB, NG, SPT, true>(m1, m2, Pl, Pr, pi, w, part, KC,
                                           M, G, Ab, S, threads, tiles, st);
  }
  return launch_fwd<AB, NG, SPT, false>(m1, m2, Pl, Pr, pi, w, part, KC, M,
                                        G, Ab, S, threads, tiles, st);
}

// Shared-memory bytes K7 wide (tf false) and K11c (tf true) need at a
// chunk of SC sites (pruning/kernels.py::twist_bwd_plan mirrors it).
size_t bwd_smem(int G, int Ab, int SC, bool tf) {
  const int NPG = (Ab + 3) / 4, NGT = G * NPG, GA = G * Ab;
  return ((size_t)(4 * GA + NGT + 1) * (SC + 4) +
          (8 + (tf ? 1 : 0)) * (size_t)GA * 4 * NPG + ((GA + 3) & ~3)) *
         sizeof(float);
}

int launch_bwd(const float* m1, const float* m2, const float* Pl,
               const float* Pr, const float* pi, const float* w,
               const float* g, float* dm1, float* dm2, float* dPl,
               float* dPr, int KC, int M, int G, int Ab, int S, int SC,
               int threads, int smem, bool tf, void* stream) {
  if (KC <= 0) return 0;
  if (M < 0 || S <= 0 || G < 1 || G > kMaxG || Ab < 1 ||
      G * Ab > kMaxPlanes || SC < 4 || SC % 4 || SC > kBwdMaxSC ||
      (tf && G != 1))
    return (int)cudaErrorInvalidValue;
  const int NGT = G * ((Ab + 3) / 4);
  if (threads % 32 || threads > kBwdMaxThreads || threads < NGT * (SC / 4) ||
      smem > kSmemMax || (size_t)smem < bwd_smem(G, Ab, SC, tf))
    return (int)cudaErrorInvalidValue;
  auto kernel =
      tf ? (Ab == 16 ? pair_ll_bwd_t_wide_kernel<16>
                     : pair_ll_bwd_t_wide_kernel<0>)
         : (Ab == 4    ? pair_ll_bwd_wide_kernel<4>
            : Ab == 16 ? pair_ll_bwd_wide_kernel<16>
                       : pair_ll_bwd_wide_kernel<0>);
  const int err = allow_smem(kernel, (size_t)smem);
  if (err) return err;
  const bool vecM = S % 4 == 0 && aligned(m1, 16) && aligned(m2, 16);
  kernel<<<KC, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, G, Ab, S, SC,
      vecM);
  return (int)cudaGetLastError();
}

}  // namespace

// K11b.  G = 1 is the dense form (Ab = A).  spt, threads and tiles are
// the wrapper's plan (pruning/kernels.py::twist_fwd_plan); a plan that
// does not match the instantiation is refused.
extern "C" int launch_pair_ll_fwd(const float* m1, const float* m2,
                                  const float* Pl, const float* Pr,
                                  const float* pi, const float* w,
                                  float* part, int KC, int M, int G, int Ab,
                                  int S, int spt, int threads, int tiles,
                                  void* stream) {
  if (KC <= 0 || M <= 0) return 0;
  if (S <= 0 || G < 1 || G > kMaxG || Ab < 1 || G * Ab > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int AB = pow2_at_least(Ab < 4 ? 4 : Ab);
  const int NG = G == 1 ? 1 : pow2_at_least(G);
#define PAIR_LL_FWD(ab, ng)                                               \
  if (AB == ab && NG == ng)                                               \
    return spt != fwd_spt(ab * ng)                                        \
               ? (int)cudaErrorInvalidValue                               \
               : run_fwd<ab, ng, fwd_spt(ab * ng)>(                       \
                     m1, m2, Pl, Pr, pi, w, part, KC, M, G, Ab, S,        \
                     threads, tiles, st);
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
  return (int)cudaErrorInvalidValue;   // padded planes over kMaxPlanes
}

// K7 wide.  G = 1 is the dense form (Ab = A > 8).  SC, threads and smem
// are the wrapper's plan (pruning/kernels.py::twist_bwd_plan), checked
// against the layout here.
extern "C" int launch_pair_ll_bwd_wide(const float* m1, const float* m2,
                                       const float* Pl, const float* Pr,
                                       const float* pi, const float* w,
                                       const float* g, float* dm1,
                                       float* dm2, float* dPl, float* dPr,
                                       int KC, int M, int G, int Ab, int S,
                                       int SC, int threads, int smem,
                                       void* stream) {
  return launch_bwd(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, G,
                    Ab, S, SC, threads, smem, false, stream);
}

// K11c above 8 states (at A <= 8: twist_kernels.cu's launch_pair_ll_bwd_t):
// dense, A <= 64; SC, threads and smem from twist_bwd_plan's T-field
// plan.  The same outputs as K7 wide, dP_l and dP_r formed from T in the
// kernel.
extern "C" int launch_pair_ll_bwd_t(const float* m1, const float* m2,
                                    const float* Pl, const float* Pr,
                                    const float* pi, const float* w,
                                    const float* g, float* dm1, float* dm2,
                                    float* dPl, float* dPr, int KC, int M,
                                    int A, int S, int SC, int threads,
                                    int smem, void* stream) {
  return launch_bwd(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, 1,
                    A, S, SC, threads, smem, true, stream);
}
