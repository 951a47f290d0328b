// Kernels K7, K11c (at A <= 8) and K8 of phylo_tpu_torch: the VNCSMC
// pair-loglik backward, its T-field form, and the merge on explicit
// children.
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
// K11c replaces the same function's T-field body _kernel_ll_bwd2
// (PHYLO_TWIST_BWD_V2; twist_wide_kernels.cu holds it above 8 states).
// Its dm terms are K7's; its dP is K7's in another association: with
// gsite = g w / site and T[a, a'] = sum_s gsite m1[a] m2[a'],
//
//     dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b]
//     dP_r[a', b] = pi_b sum_a T[a, a'] P_l[a, b].
//
// The JAX package forms dP from T outside its kernel; here the kernel
// forms it from the T sums in shared memory and returns dP_l, dP_r as
// K7 does (the same function).
//
// K8 replaces ::fused_merge_loglik (body _kernel via _pallas_forward):
// K1's merge, rescale and root log-lik on children given explicitly,
// writing the merged message to its own output.
//
// Layout as in rank_kernels.cu: states-major (A, S) slabs contiguous in
// S, transitions (.., A, A) row-major with u[b] = sum_a m[a] P[a, b].
//
// What bounds them on an H100.  K8: at the twist's K = 32 chosen merges
// nothing but latency (its bytes take 0.0001-0.0004 ms): one launch, a
// load of the children, 4 A^2 FMAs and two logs a site, and a fixed-order
// sum of S values.  K7: operations -- per (m, k, s) it recomputes u and v
// (2 A^2 FMAs), then forms du, dv and both the dm and dP terms (4 A^2
// FMAs more), M times over the same children, so at M=10 it does ~60 A^2
// FMAs per site for 4A floats read and 2A written.  K11c: the same, with
// A^2 T terms a site in place of the 2 A^2 dP terms, plus 4 A^3 per
// (m, row) for dP from T.
//
// Design of K8.  A thread a site, no serial walk: a block a particle,
// its S sites over up to 1024 threads, a site a thread a pass and more
// passes beyond that (above 4 states up to 512 threads: the launch
// bound's 64 registers spilled there; pruning/kernels.py::merge_ll_plan).
// Two sites a thread a pass ran 1.1x slower at S = 256 and 898 and was
// dropped.  The children's loads are issued
// first; one warp stages P_l[k], P_r[k] and pi into shared memory
// meanwhile (one coalesced load, not 2 A^2 loads a thread).  The site
// sums rootll, logscale (w-weighted logs, logf) are a chain over a
// thread's sites, a warp's butterfly and the warps' totals by one more
// butterfly (no atomics: the same bits every call).  A cluster of up to
// 8 blocks a particle, summed through distributed shared memory, ran
// 1.1-1.5x slower at K = 32, S = 256 and 898 (tools/torch_k11c_k8_forms.py)
// and was dropped.
//
// Design of K7 and K11c (one body; K11c is its T_FIELD form).  The
// former body (one 128-thread block a row, and for every m a block-wide
// reduction of the 2 A^2 dP partials) spent 3-4x its FMAs on that
// reduction.  Now a warp owns a (row, chunk of 32 SPL sites), lane l
// the sites c 32 SPL + 32 j + l (j < SPL), and a block a row: its W warps
// take the chunks c = w, w + W, ...  At primate rank 0 (M = 10, KC =
// 2112, S = 256) that is SPL = 2, W = 1: 2,112 warps of 4 chunks each.
// * P_l[:, k], P_r[:, k] for all M (2 M A^2 floats, 1.3 KB at M = 10,
//   A = 4) and g[:, k] come into shared memory once a row by cp.async;
//   a lane reads an m's transitions as float4 broadcasts.
// * A lane holds its sites' children, weights and dm accumulators in
//   registers across all M, and writes dm once a site.
// * Per m, a lane forms its NV partials of its SPL sites as FMA chains
//   (K7: the 2 A^2 dP partials; K11c: the A^2 T partials, half as many),
//   and the warp reduces them with one transpose_sum (31 shuffles at
//   A = 4 for K7, 16 for K11c; no barrier); each lane adds its share
//   onto the warp's (m, entry) slot in shared memory, in chunk order.
// * After the m loop, one barrier; the block sums the warps' slots in
//   warp order.  K7 writes every dP entry once per (m, row); K11c first
//   puts T in warp 0's slots, then forms each dP entry from T and the
//   staged P (A FMAs, 2 A^3 a (m, row)) and writes it once.
// Ragged site chunks are masked, not padded.  The plan (SPL, W) comes
// from pruning/kernels.py::twist_narrow_plan: SPL = 2 (115 registers at
// A = 4; SPL = 4 needs 162 and ran 22% slower), halved on a short grid
// (later ranks have fewer rows), and as few warps a row as give the grid
// 16 warps an SM: one warp walking a row's chunks beat two or four.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>

namespace {

// K8: threads a block at most (pruning/kernels.py::MERGE_MAX_THREADS
// mirrors it), half of it above 4 states (128 registers a thread)
constexpr int kK8MaxThreads = 1024;

__host__ __device__ constexpr int k8_max_threads(int A) {
  return A <= 4 ? kK8MaxThreads : kK8MaxThreads / 2;
}
// K7: warps a row at most (pruning/kernels.py::K7_MAX_WARPS mirrors it)
// and the launch bound's blocks an SM
constexpr int kK7MaxWarps = 8;
constexpr int kK7MinBlocks = 1;

// lane 0 gets the warp's sum: pairs (l, l + 16), then + 8, ... + 1
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sums the N values v over a warp's 32 lanes by recursive halving (as
// rank_kernels.cu's transpose_sum): at the xor-O step a lane keeps half
// of its values, sends the other half to its partner and adds the
// partner's copy of the half it keeps, so after the five steps lane L
// holds the warp totals of indices [base, base + size) in v[0, size).
// Each total is the butterfly sum over lanes (pairs L, L^16 first, then
// L^8, ...), the same bits in every call; about N shuffles in all.
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

// Floats of an m's P_l | P_r row in shared memory (16-byte pitch).
__host__ __device__ constexpr int k7_pitch(int A) {
  return (2 * A * A + 3) & ~3;
}

// ------------------------------------------------------------------- K8
// grid (K,): block k the particle k.  Thread t owns the sites t, t + T,
// t + 2 T, ... (T = blockDim.x, one a pass; the plan makes one pass up to
// T sites).  Shared memory: P_l[k] | P_r[k] | pi, then the warps' two
// sums.
template <int A>
__global__ void __launch_bounds__(k8_max_threads(A)) merge_loglik_kernel(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    float* __restrict__ merged, float* __restrict__ rootll,
    float* __restrict__ logscale, int S) {
  constexpr int AA = A * A;
  constexpr int NP = 2 * AA + A;
  __shared__ float pq[NP];
  __shared__ float red[2 * 32];
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int TT = blockDim.x;
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* out = merged + (size_t)k * slab;

  float acc0 = 0.f, acc1 = 0.f;
  bool staged = false;
  for (int s0 = t; s0 - t < S; s0 += TT) {
    // this pass's children first: their loads overlap P's staging
    float a1[A], a2[A];
    const bool ok = s0 < S;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      a1[a] = ok ? __ldg(m1 + (size_t)a * S + s0) : 1.f;
      a2[a] = ok ? __ldg(m2 + (size_t)a * S + s0) : 1.f;
    }
    if (!staged) {
      if (warp == 0) {
        for (int e = lane; e < NP; e += 32)
          pq[e] = e < AA       ? __ldg(Pl + (size_t)k * AA + e)
                  : e < 2 * AA ? __ldg(Pr + (size_t)k * AA + e - AA)
                               : __ldg(pi + e - 2 * AA);
      }
      __syncthreads();
      staged = true;
    }
    float wv[A];
#pragma unroll
    for (int b = 0; b < A; ++b) {
      float u = __fmul_rn(a1[0], pq[b]);
      float v = __fmul_rn(a2[0], pq[AA + b]);
#pragma unroll
      for (int a = 1; a < A; ++a) {
        u = __fmaf_rn(a1[a], pq[a * A + b], u);
        v = __fmaf_rn(a2[a], pq[AA + a * A + b], v);
      }
      wv[b] = __fmul_rn(u, v);
    }
    float raw = wv[0];
#pragma unroll
    for (int b = 1; b < A; ++b) raw = fmaxf(raw, wv[b]);
    const float scale = fmaxf(raw, FLT_MIN);
    float site = __fmul_rn(wv[0], pq[2 * AA]);
#pragma unroll
    for (int b = 1; b < A; ++b)
      site = __fmaf_rn(wv[b], pq[2 * AA + b], site);
    if (ok) {
#pragma unroll
      for (int b = 0; b < A; ++b)
        out[(size_t)b * S + s0] = __fdiv_rn(wv[b], scale);
      const float ws = __ldg(w + s0);
      acc0 = __fmaf_rn(logf(site), ws, acc0);
      acc1 = __fmaf_rn(logf(scale), ws, acc1);
    }
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  if (lane == 0) {
    red[2 * warp] = acc0;
    red[2 * warp + 1] = acc1;
  }
  __syncthreads();
  if (warp == 0) {
    acc0 = warp_sum(lane < nwarps ? red[2 * lane] : 0.f);
    acc1 = warp_sum(lane < nwarps ? red[2 * lane + 1] : 0.f);
    if (lane == 0) {
      rootll[k] = acc0;
      logscale[k] = acc1;
    }
  }
}

// ------------------------------------------------------------ K7 / K11c
// One body: a block a row k, warps over site chunks (see the design
// above); TF, the T-field form (K11c).  Shared memory: M rows of P_l[m,
// k] | P_r[m, k] at pitch k7_pitch(A), g[:, k] (M floats, padded to 4),
// then each warp's M x NV slots (K7: the 2 A^2 dP sums; K11c: the A^2 T
// sums).
template <int A, int SPL, bool TF>
__device__ __forceinline__ void k7_body(
    const float* __restrict__ m1g, const float* __restrict__ m2g,
    const float* __restrict__ Pl, const float* __restrict__ Pr,
    const float* __restrict__ pi, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ dm1g,
    float* __restrict__ dm2g, float* __restrict__ dPl,
    float* __restrict__ dPr, int KC, int M, int S) {
  constexpr int AA = A * A;
  constexpr int NV = TF ? AA : 2 * AA;  // a lane's partials of one m
  constexpr int NF = halved5(NV);       // values a lane keeps after the sum
  constexpr int PP = k7_pitch(A);
  constexpr int CH = 32 * SPL;          // sites a chunk
  extern __shared__ float4 smem4[];
  float* const pm = reinterpret_cast<float*>(smem4);
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  float* const gm = pm + (size_t)M * PP;
  float* const slot = gm + ((M + 3) & ~3);
  float* const myslot = slot + (size_t)warp * M * NV;
  for (int e = threadIdx.x; e < M * 2 * AA; e += blockDim.x) {
    const int m = e / (2 * AA), c = e - m * 2 * AA;
    const size_t row = (size_t)m * KC + k;
    cp_async4(pm + m * PP + c,
              c < AA ? Pl + row * AA + c : Pr + row * AA + (c - AA));
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    gm[m] = g[(size_t)m * KC + k];
  float pv[A];
#pragma unroll
  for (int a = 0; a < A; ++a) pv[a] = pi[a];
  const size_t slab = (size_t)A * S;
  const float* m1 = m1g + (size_t)k * slab;
  const float* m2 = m2g + (size_t)k * slab;
  float* dm1 = dm1g + (size_t)k * slab;
  float* dm2 = dm2g + (size_t)k * slab;
  cp_async_wait_all();
  __syncthreads();                      // P, g of every m are in

  const int nch = (S + CH - 1) / CH;
  for (int c = warp, it = 0; c < nch; c += W, ++it) {
    float a1[SPL][A], a2[SPL][A], d1[SPL][A], d2[SPL][A], ws[SPL];
    bool ok[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = c * CH + 32 * j + lane;
      ok[j] = s < S;
      ws[j] = ok[j] ? w[s] : 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        a1[j][a] = ok[j] ? m1[(size_t)a * S + s] : 0.f;
        a2[j][a] = ok[j] ? m2[(size_t)a * S + s] : 0.f;
        d1[j][a] = d2[j][a] = 0.f;
      }
    }
    for (int m = 0; m < M; ++m) {
      float pl[AA], pr[AA];
      const float* row = pm + m * PP;
      if constexpr (AA % 4 == 0) {
#pragma unroll
        for (int e = 0; e < AA; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + e);
          const float4 y = *reinterpret_cast<const float4*>(row + AA + e);
          pl[e] = x.x; pl[e + 1] = x.y; pl[e + 2] = x.z; pl[e + 3] = x.w;
          pr[e] = y.x; pr[e + 1] = y.y; pr[e + 2] = y.z; pr[e + 3] = y.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < AA; ++e) {
          pl[e] = row[e];
          pr[e] = row[AA + e];
        }
      }
      const float gk = gm[m];
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        float u[A], v[A];
        float site = 0.f;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          float uu = __fmul_rn(a1[j][0], pl[b]), vv = __fmul_rn(a2[j][0], pr[b]);
#pragma unroll
          for (int a = 1; a < A; ++a) {
            uu = __fmaf_rn(a1[j][a], pl[a * A + b], uu);
            vv = __fmaf_rn(a2[j][a], pr[a * A + b], vv);
          }
          u[b] = uu;
          v[b] = vv;
          site = __fmaf_rn(__fmul_rn(uu, vv), pv[b], site);
        }
        // a masked site carries nothing (its 0 / 0 is never used)
        const float gsite =
            ok[j] ? __fdiv_rn(__fmul_rn(gk, ws[j]), site) : 0.f;
        if constexpr (TF) {
          // T[a, a'] += (gsite m1[a]) m2[a']
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const float x = __fmul_rn(gsite, a1[j][a]);
#pragma unroll
            for (int a2_ = 0; a2_ < A; ++a2_)
              acc[a * A + a2_] = __fmaf_rn(x, a2[j][a2_], acc[a * A + a2_]);
          }
        }
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const float du = __fmul_rn(gsite, __fmul_rn(v[b], pv[b]));
          const float dv = __fmul_rn(gsite, __fmul_rn(u[b], pv[b]));
#pragma unroll
          for (int a = 0; a < A; ++a) {
            d1[j][a] = __fmaf_rn(du, pl[a * A + b], d1[j][a]);
            d2[j][a] = __fmaf_rn(dv, pr[a * A + b], d2[j][a]);
            if constexpr (!TF) {
              acc[a * A + b] = __fmaf_rn(du, a1[j][a], acc[a * A + b]);
              acc[AA + a * A + b] =
                  __fmaf_rn(dv, a2[j][a], acc[AA + a * A + b]);
            }
          }
        }
      }
      int base = 0, size = NV;
      transpose_sum<NV, 16>(acc, lane, base, size);
      float* sl = myslot + m * NV + base;
#pragma unroll
      for (int i = 0; i < NF; ++i)
        if (i < size) sl[i] = it ? sl[i] + acc[i] : acc[i];
    }
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      if (!ok[j]) continue;
      const int s = c * CH + 32 * j + lane;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        dm1[(size_t)a * S + s] = d1[j][a];
        dm2[(size_t)a * S + s] = d2[j][a];
      }
    }
  }
  __syncthreads();                      // every warp's slots are in
  if constexpr (TF) {
    // T: the warps' slots in warp order, onto warp 0's
    if (W > 1) {
      for (int e = threadIdx.x; e < M * AA; e += blockDim.x) {
        float t = slot[e];
        for (int q = 1; q < W; ++q) t += slot[(size_t)q * M * AA + e];
        slot[e] = t;
      }
      __syncthreads();
    }
    // dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b], dP_r[a', b] = pi_b
    // sum_a T[a, a'] P_l[a, b]: chains over a' (a) ascending, then pi_b;
    // each entry written once per (m, k)
    for (int e = threadIdx.x; e < M * 2 * AA; e += blockDim.x) {
      const int m = e / (2 * AA), c = e - m * 2 * AA;
      const float* T = slot + m * AA;
      const float* row = pm + m * PP;
      const size_t out = ((size_t)m * KC + k) * AA;
      if (c < AA) {
        const int a = c / A, b = c - a * A;
        float t = __fmul_rn(T[a * A], row[AA + b]);
#pragma unroll
        for (int q = 1; q < A; ++q)
          t = __fmaf_rn(T[a * A + q], row[AA + q * A + b], t);
        dPl[out + c] = __fmul_rn(t, __ldg(pi + b));
      } else {
        const int a2_ = (c - AA) / A, b = c - AA - a2_ * A;
        float t = __fmul_rn(T[a2_], row[b]);
#pragma unroll
        for (int q = 1; q < A; ++q)
          t = __fmaf_rn(T[q * A + a2_], row[q * A + b], t);
        dPr[out + (c - AA)] = __fmul_rn(t, __ldg(pi + b));
      }
    }
  } else {
    // the warps' slots in warp order: each dP entry written once per (m, k)
    for (int e = threadIdx.x; e < M * NV; e += blockDim.x) {
      float t = slot[e];
      for (int q = 1; q < W; ++q) t += slot[(size_t)q * M * NV + e];
      const int m = e / NV, c = e - m * NV;
      const size_t row = (size_t)m * KC + k;
      if (c < AA)
        dPl[row * AA + c] = t;
      else
        dPr[row * AA + (c - AA)] = t;
    }
  }
}

#define PHYLO_K7_ARGS                                                      \
  const float *__restrict__ m1g, const float *__restrict__ m2g,            \
      const float *__restrict__ Pl, const float *__restrict__ Pr,          \
      const float *__restrict__ pi, const float *__restrict__ w,           \
      const float *__restrict__ g, float *__restrict__ dm1g,               \
      float *__restrict__ dm2g, float *__restrict__ dPl,                   \
      float *__restrict__ dPr, int KC, int M, int S
#define PHYLO_K7_CALL \
  m1g, m2g, Pl, Pr, pi, w, g, dm1g, dm2g, dPl, dPr, KC, M, S

// K7.  MINB: the launch bound's blocks an SM (registers a thread at most
// 65536 / (256 MINB)); the launcher's is kK7MinBlocks.
template <int A, int SPL, int MINB = kK7MinBlocks>
__global__ void __launch_bounds__(32 * kK7MaxWarps, MINB)
    pair_ll_bwd_narrow_kernel(PHYLO_K7_ARGS) {
  k7_body<A, SPL, false>(PHYLO_K7_CALL);
}

// K11c at A <= 8: K7's body in its T-field form.
template <int A, int SPL, int MINB = kK7MinBlocks>
__global__ void __launch_bounds__(32 * kK7MaxWarps, MINB)
    pair_ll_bwd_t_narrow_kernel(PHYLO_K7_ARGS) {
  k7_body<A, SPL, true>(PHYLO_K7_CALL);
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

// K8.  threads (a multiple of 32, at most k8_max_threads(A)) come from
// pruning/kernels.py::merge_ll_plan.
extern "C" int launch_merge_loglik(const float* m1, const float* m2,
                                   const float* Pl, const float* Pr,
                                   const float* pi, const float* w,
                                   float* merged, float* rootll,
                                   float* logscale, int K, int A, int S,
                                   int threads, void* stream) {
  if (K <= 0) return 0;
  if (S <= 0 || A < 1 || threads < 32 || threads % 32 ||
      threads > k8_max_threads(A))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_K8(AA)                                                       \
  case AA:                                                                 \
    merge_loglik_kernel<AA><<<K, threads, 0, st>>>(                        \
        m1, m2, Pl, Pr, pi, w, merged, rootll, logscale, S);               \
    break;
    PHYLO_A_CASES(PHYLO_K8)
#undef PHYLO_K8
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Shared-memory bytes of K7 (tf false) and K11c at A <= 8 (tf true)
// (pruning/kernels.py::k7_smem mirrors it).
static size_t k7_smem(int M, int A, int warps, bool tf = false) {
  return ((size_t)M * k7_pitch(A) + ((M + 3) & ~3) +
          (size_t)warps * M * (tf ? 1 : 2) * A * A) * sizeof(float);
}

// K7 (tf false) or K11c at A <= 8 (tf true).  spl (1, 2 or 4) and warps
// (at most the row's chunks and kK7MaxWarps) come from
// pruning/kernels.py::twist_narrow_plan.
static int launch_narrow(const float* m1, const float* m2, const float* Pl,
                         const float* Pr, const float* pi, const float* w,
                         const float* g, float* dm1, float* dm2, float* dPl,
                         float* dPr, int KC, int M, int A, int S, int spl,
                         int warps, bool tf, void* stream) {
  if (KC <= 0) return 0;
  if (M < 0 || S <= 0 || (spl != 1 && spl != 2 && spl != 4))
    return (int)cudaErrorInvalidValue;
  const int nch = (S + 32 * spl - 1) / (32 * spl);
  if (warps < 1 || warps > kK7MaxWarps || warps > nch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = k7_smem(M, A, warps, tf);
  auto launch = [&](auto kernel) {
    const int err = smem <= 48 * 1024 ? 0 : (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    kernel<<<KC, 32 * warps, smem, st>>>(m1, m2, Pl, Pr, pi, w, g, dm1, dm2,
                                         dPl, dPr, KC, M, S);
    return (int)cudaGetLastError();
  };
  switch (A) {
#define PHYLO_K7(AA)                                                       \
  case AA:                                                                 \
    if (tf)                                                                \
      return spl == 1   ? launch(pair_ll_bwd_t_narrow_kernel<AA, 1>)       \
             : spl == 2 ? launch(pair_ll_bwd_t_narrow_kernel<AA, 2>)       \
                        : launch(pair_ll_bwd_t_narrow_kernel<AA, 4>);      \
    return spl == 1   ? launch(pair_ll_bwd_narrow_kernel<AA, 1>)           \
           : spl == 2 ? launch(pair_ll_bwd_narrow_kernel<AA, 2>)           \
                      : launch(pair_ll_bwd_narrow_kernel<AA, 4>);
    PHYLO_A_CASES(PHYLO_K7)
#undef PHYLO_K7
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7
extern "C" int launch_pair_ll_bwd(const float* m1, const float* m2,
                                  const float* Pl, const float* Pr,
                                  const float* pi, const float* w,
                                  const float* g, float* dm1, float* dm2,
                                  float* dPl, float* dPr, int KC, int M,
                                  int A, int S, int spl, int warps,
                                  void* stream) {
  return launch_narrow(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M,
                       A, S, spl, warps, false, stream);
}

// K11c at A <= 8 (twist_wide_kernels.cu's launch_pair_ll_bwd_t above):
// the same outputs as K7, dP_l and dP_r formed from T in the kernel.
extern "C" int launch_pair_ll_bwd_t(const float* m1, const float* m2,
                                    const float* Pl, const float* Pr,
                                    const float* pi, const float* w,
                                    const float* g, float* dm1, float* dm2,
                                    float* dPl, float* dPr, int KC, int M,
                                    int A, int S, int spl, int warps,
                                    void* stream) {
  return launch_narrow(m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M,
                       A, S, spl, warps, true, stream);
}
