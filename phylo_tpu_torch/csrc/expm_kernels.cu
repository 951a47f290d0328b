// Kernel K4 of phylo_tpu_torch: the uniformized delta-form expm chain
// and its Frechet-adjoint backward for a shared A x A rate matrix.
//
// Replaces phylo_tpu/models/expm_kernel.py::_fwd_impl (Pallas body
// _expm_fwd_kernel) and ::_bwd_impl (body _expm_bwd_kernel, with its
// jnp.sum over the batch) plus the b_bar of ::_expm_bwd.
//
// Forward, per batch element i with branch length b_i, from Q alone:
//   mu = max(max_k -Q_kk, 1e-30), R = Q / mu + I (uniformize's IEEE ops),
//   b_eff = min(b, 80 / mu), x = mu b_eff / 2^s,
//   S = (x / order) R;  S <- (x / j) (R + R S) for j = order-1 .. 1;
//   D = S;  D <- 2 D + D D  (s times);  P = e^{-mu b_eff} (I + D).
// Backward: the same chain on the block pair (T, F) of
//   [[x R^T, Pbar / 2^s], [0, x R^T]],  (T1, F1)(T2, F2) = (T1 T2,
//   T1 F2 + F1 T2), written with E = Pbar / 2^s as
//   SF <- (x / j) R^T SF + (1 / j) (E + E ST),
//   ST <- (x / j) (R^T + R^T ST),
//   DF <- 2 DF + DT DF + DF DT,  DT <- 2 DT + DT DT;
//   Q_bar = sum_i b_eff_i e^{-mu b_eff_i} DF_i, and
//   b_bar_i = <Pbar_i, Q P_i>, zero where b_i > 80 / mu.
//
// What bounds it on an H100: FP32 operations.  Per element the forward
// runs order - 1 + squarings = 23 dependent 4 x 4 products (~2,070 FMA,
// multiply and add instructions) against 4 + 64 bytes; the backward three
// products a step plus b_bar (~5,500 instructions) against ~136 bytes.
// Tensor cores do not fit: the ROADMAP numerics rules require exact FP32
// A x A contractions (TF32 keeps ~3 digits, far from the forward's 1e-6),
// and FP64 DMMA (m8n8k4) peaks at the FP32 pipes' 67 TFLOP/s while
// wasting half its tile on a 4 x 4 product.  TMA would only stage 4 B
// (forward) or 132 B (backward) an element under thousands of FMAs.
//
// Design, against what held the first port back (IEEE divisions in the
// chain, a backward of ~150 live registers at 8 warps an SM, Q_bar and
// b_bar left to torch ops over a (B, A, A) field and a (B, A, A, A)
// broadcast, grids of 256-thread blocks that left SMs idle):
// - No division in the chain.  One scalar c = x * (1/j) scales each
//   product, with 1/j from a constant table rounded at compile time.
//   Q / mu and 80 / mu, the only divisions, run once a block.  The
//   backward's FMA chains start at E_ik, R^T_ik and 2 D_ik.  The
//   forward's sum the products first and add R or 2 D after, as the
//   plain version's torch ops do: at mu b = 80 the squarings amplify any
//   rounding of the first-order term about t = 80-fold, so two float32
//   chains that round at other places differ by up to ~4e-6 there, over
//   the 1e-6 the kernel is held to.
// - (order, squarings) = (12, 12), the only pair any path uses, is a
//   compile-time instance with every loop unrolled, built for A = 4 (the
//   only alphabet a path sends here); a generic instance with the same
//   body and runtime loops runs every other pair and alphabet.
// - R, Q, mu and 80 / mu are computed once a block into shared memory
//   (while the thread's own inputs are in flight) and loaded once a
//   thread: no per-element copy, no separate launch.
// - Horner steps update S (forward) and (ST, SF) (backward) a column at a
//   time in place, since column k of the new state reads only column k of
//   the old: the backward's live state is E, ST, SF, R and one 16-float
//   temporary for the squarings.  Register budgets: 32 forward (64 warps
//   an SM), 64 backward (32 warps, a few bytes spilled), each faster on
//   the H100 than the unconstrained 48 and 122.
// - The backward reduces Q_bar itself: each thread's w_i DF_i is summed
//   over its warp by a fixed xor-shuffle split, over the block's warps in
//   order, and written as one partial a block; the last block to take a
//   ticket sums the partials in a fixed order with eight 16-byte loads in
//   flight a thread.  No float atomics: the same inputs give the same
//   bits.  b_bar comes from the saved P in the same launch; the
//   per-element field is never written.
// - Block size and grid come from models/expm_kernel.py::expm_plan
//   (64-256 threads, chosen so that the busiest of the 132 SMs gets the
//   fewest elements; the backward takes 256 at large batches, where
//   every block's partial and barriers cost); the launchers check it.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMinThreads = 64;    // expm_plan's block sizes: 64 .. 256,
constexpr int kMaxThreads = 512;   // and 512 for tools/torch_expm_forms.py
constexpr int kMaxOrder = 32;      // the reciprocal table's length

// 1/j, each rounded once when compiled; the unrolled instance reads them
// as constant-bank operands, the generic one by index
__constant__ float kInv[kMaxOrder + 1] = {
    0.f,        1.f / 1.f,  1.f / 2.f,  1.f / 3.f,  1.f / 4.f,  1.f / 5.f,
    1.f / 6.f,  1.f / 7.f,  1.f / 8.f,  1.f / 9.f,  1.f / 10.f, 1.f / 11.f,
    1.f / 12.f, 1.f / 13.f, 1.f / 14.f, 1.f / 15.f, 1.f / 16.f, 1.f / 17.f,
    1.f / 18.f, 1.f / 19.f, 1.f / 20.f, 1.f / 21.f, 1.f / 22.f, 1.f / 23.f,
    1.f / 24.f, 1.f / 25.f, 1.f / 26.f, 1.f / 27.f, 1.f / 28.f, 1.f / 29.f,
    1.f / 30.f, 1.f / 31.f, 1.f / 32.f};

// What every element of a call shares, computed once a block.
template <int A>
struct Uniform {
  float R[A * A];
  float Q[A * A];
  float mu, clampv;
};

// uniformize(Q) with torch's operations: mu = clamp(max(-diag Q), 1e-30),
// R = Q / mu + I, and the clamp 80 / mu.  Threads below A*A take an entry
// each; the caller synchronises.
template <int A>
__device__ __forceinline__ void load_uniform(const float* __restrict__ Q,
                                             Uniform<A>& u) {
  const int t = threadIdx.x;
  if (t >= A * A) return;
  float m = -Q[0];
#pragma unroll
  for (int k = 1; k < A; ++k) m = fmaxf(m, -Q[k * A + k]);
  const float mu = fmaxf(m, 1e-30f);
  const float q = Q[t];
  u.Q[t] = q;
  u.R[t] = __fadd_rn(__fdiv_rn(q, mu), (t / A == t % A) ? 1.f : 0.f);
  if (t == 0) {
    u.mu = mu;
    u.clampv = __fdiv_rn(80.f, mu);
  }
}

// torch.minimum(b, 80 / mu), NaN in b propagating as it does there
__device__ __forceinline__ float clamp_b(float b, float clampv) {
  return clampv < b ? clampv : b;
}

// S <- c (R + R S), a column at a time in place (column k of the new S
// reads only column k of the old).  R S is summed first and R added
// after, as the plain version's torch ops round them (see the note at
// the top).
template <int A, class RA>
__device__ __forceinline__ void horner_fwd(const RA& R, float c,
                                           float (&S)[A * A]) {
#pragma unroll
  for (int k = 0; k < A; ++k) {
    float t[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      float p = R[i * A] * S[k];
#pragma unroll
      for (int m = 1; m < A; ++m) p = fmaf(R[i * A + m], S[m * A + k], p);
      t[i] = c * (R[i * A + k] + p);
    }
#pragma unroll
    for (int i = 0; i < A; ++i) S[i * A + k] = t[i];
  }
}

// D <- 2 D + D D, D D summed first (2 D is exact, so the last FMA rounds
// as the plain version's 2 D + (D D) does)
template <int A>
__device__ __forceinline__ void square_fwd(float (&D)[A * A]) {
  float t[A * A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      float p = D[i * A] * D[k];
#pragma unroll
      for (int m = 1; m < A; ++m) p = fmaf(D[i * A + m], D[m * A + k], p);
      t[i * A + k] = fmaf(2.f, D[i * A + k], p);
    }
  }
#pragma unroll
  for (int c = 0; c < A * A; ++c) D[c] = t[c];
}

// One element's forward: P_i into S.  ORDER = 0 runs the runtime
// (order, squarings) with rolled loops.
template <int A, int ORDER, int SQ, class RA>
__device__ __forceinline__ void fwd_element(const RA& R, float mu,
                                            float clampv, float bi,
                                            float (&S)[A * A], int order,
                                            int squarings) {
  const int ord = ORDER > 0 ? ORDER : order;
  const int sq = ORDER > 0 ? SQ : squarings;
  const float beff = clamp_b(bi, clampv);
  const float x = (mu * beff) * ldexpf(1.f, -sq);
  const float c0 = x * kInv[ord];
#pragma unroll
  for (int c = 0; c < A * A; ++c) S[c] = c0 * R[c];
  if constexpr (ORDER > 0) {
#pragma unroll
    for (int j = ORDER - 1; j >= 1; --j) horner_fwd<A>(R, x * kInv[j], S);
#pragma unroll
    for (int q = 0; q < SQ; ++q) square_fwd<A>(S);
  } else {
#pragma unroll 1
    for (int j = ord - 1; j >= 1; --j) horner_fwd<A>(R, x * kInv[j], S);
#pragma unroll 1
    for (int q = 0; q < sq; ++q) square_fwd<A>(S);
  }
  const float sc = expf(-mu * beff);
#pragma unroll
  for (int c = 0; c < A * A; ++c)
    S[c] = sc * (S[c] + (c / A == c % A ? 1.f : 0.f));
}

// A*A floats between registers and memory, as float4 where they fit
template <int A>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&v)[A * A]) {
  if constexpr ((A * A) % 4 == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int c = 0; c < A * A / 4; ++c)
      d4[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < A * A; ++c) dst[c] = v[c];
  }
}

// 32 registers a thread (64 warps an SM at A = 4): on an H100 6-9%
// quicker than the 48 it takes unconstrained (tools/torch_expm_forms.py)
template <int A, int ORDER, int SQ>
__global__ void __launch_bounds__(kMaxThreads, 4) expm_fwd_kernel(
    const float* __restrict__ Q, const float* __restrict__ b,
    float* __restrict__ P, int B, int order, int squarings) {
  __shared__ Uniform<A> u;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float bi = i < B ? b[i] : 0.f;     // in flight across the barrier
  load_uniform<A>(Q, u);
  __syncthreads();
  if (i >= B) return;
  float R[A * A], Pi[A * A];
#pragma unroll
  for (int c = 0; c < A * A; ++c) R[c] = u.R[c];
  fwd_element<A, ORDER, SQ>(R, u.mu, u.clampv, bi, Pi, order, squarings);
  store_row<A>(P + (size_t)i * A * A, Pi);
}

template <int A>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&v)[A * A]) {
  if constexpr ((A * A) % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int c = 0; c < A * A / 4; ++c) {
      const float4 f = s4[c];
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < A * A; ++c) v[c] = src[c];
  }
}

// One backward Horner step with c = x / j, ij = 1 / j:
//   SF <- c R^T SF + ij (E + E ST),  ST <- c (R^T + R^T ST),
// a column at a time in place (both new columns read only the old ones)
template <int A, class RA>
__device__ __forceinline__ void horner_bwd(const RA& R, float c, float ij,
                                           const float (&E)[A * A],
                                           float (&ST)[A * A],
                                           float (&SF)[A * A]) {
#pragma unroll
  for (int k = 0; k < A; ++k) {
    float tf[A], tt[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      float rf = R[i] * SF[k];                 // (R^T SF)_ik, m = 0
      float ef = E[i * A + k];
      float rt = R[k * A + i];                 // R^T_ik
#pragma unroll
      for (int m = 0; m < A; ++m) {
        if (m > 0) rf = fmaf(R[m * A + i], SF[m * A + k], rf);
        ef = fmaf(E[i * A + m], ST[m * A + k], ef);
        rt = fmaf(R[m * A + i], ST[m * A + k], rt);
      }
      tf[i] = fmaf(c, rf, ij * ef);
      tt[i] = c * rt;
    }
#pragma unroll
    for (int i = 0; i < A; ++i) {
      SF[i * A + k] = tf[i];
      ST[i * A + k] = tt[i];
    }
  }
}

// DF <- 2 DF + DT DF + DF DT, then DT <- 2 DT + DT DT
template <int A>
__device__ __forceinline__ void square_bwd(float (&DT)[A * A],
                                           float (&DF)[A * A]) {
  float t[A * A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      float acc = 2.f * DF[i * A + k];
#pragma unroll
      for (int m = 0; m < A; ++m)
        acc = fmaf(DT[i * A + m], DF[m * A + k], acc);
#pragma unroll
      for (int m = 0; m < A; ++m)
        acc = fmaf(DF[i * A + m], DT[m * A + k], acc);
      t[i * A + k] = acc;
    }
  }
#pragma unroll
  for (int c = 0; c < A * A; ++c) DF[c] = t[c];
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      float acc = 2.f * DT[i * A + k];
#pragma unroll
      for (int m = 0; m < A; ++m)
        acc = fmaf(DT[i * A + m], DT[m * A + k], acc);
      t[i * A + k] = acc;
    }
  }
#pragma unroll
  for (int c = 0; c < A * A; ++c) DT[c] = t[c];
}

// One element's backward from its P (Pv) and P_bar (E, scaled in place):
// returns b_bar_i and leaves w_i DF_i in `out`.
template <int A, int ORDER, int SQ, class RA, class QA>
__device__ __forceinline__ float bwd_element(
    const RA& R, const QA& Q, float mu, float clampv, float bi,
    const float (&Pv)[A * A], float (&E)[A * A], float (&out)[A * A],
    int order, int squarings) {
  const int ord = ORDER > 0 ? ORDER : order;
  const int sq = ORDER > 0 ? SQ : squarings;
  // b_bar = <Pbar, Q P>: (Q P)_jk over m in order, then the row-major dot
  float bbar = 0.f;
  {
#pragma unroll
    for (int j = 0; j < A; ++j) {
#pragma unroll
      for (int k = 0; k < A; ++k) {
        float qp = Q[j * A] * Pv[k];
#pragma unroll
        for (int m = 1; m < A; ++m)
          qp = fmaf(Q[j * A + m], Pv[m * A + k], qp);
        bbar = (j == 0 && k == 0) ? E[0] * qp : fmaf(E[j * A + k], qp, bbar);
      }
    }
  }
  const float beff = clamp_b(bi, clampv);
  const float inv2s = ldexpf(1.f, -sq);
  const float x = (mu * beff) * inv2s;
#pragma unroll
  for (int c = 0; c < A * A; ++c) E[c] *= inv2s;
  float ST[A * A];                             // out carries SF
  {
    const float i0 = kInv[ord];
    const float c0 = x * i0;
#pragma unroll
    for (int r = 0; r < A; ++r) {
#pragma unroll
      for (int k = 0; k < A; ++k) {
        ST[r * A + k] = c0 * R[k * A + r];
        out[r * A + k] = E[r * A + k] * i0;
      }
    }
  }
  if constexpr (ORDER > 0) {
#pragma unroll
    for (int j = ORDER - 1; j >= 1; --j)
      horner_bwd<A>(R, x * kInv[j], kInv[j], E, ST, out);
#pragma unroll
    for (int q = 0; q < SQ; ++q) square_bwd<A>(ST, out);
  } else {
#pragma unroll 1
    for (int j = ord - 1; j >= 1; --j)
      horner_bwd<A>(R, x * kInv[j], kInv[j], E, ST, out);
#pragma unroll 1
    for (int q = 0; q < sq; ++q) square_bwd<A>(ST, out);
  }
  const float w = beff * expf(-mu * beff);
#pragma unroll
  for (int c = 0; c < A * A; ++c) out[c] *= w;
  return bi <= clampv ? bbar : 0.f;
}

// Sums each of the first n values of v over the warp's 32 lanes, in a
// fixed order.  While a lane holds n > 1 values, a step at xor distance
// OFF splits them with its partner: the lane keeps the half its OFF bit
// selects and adds the partner's copy of that half (n / 2 shuffles);
// once n = 1 the remaining steps are plain xor sums.  On return the lane
// holds the warp's sums of values base .. base + max(N2 / 32, 1) - 1 in
// v[0 ..], and so does every lane that differs from it only in the bits
// of the plain steps.
template <int N2, int n, int OFF>
__device__ __forceinline__ void warp_split_sum(float (&v)[N2], int lane,
                                               int& base) {
  if constexpr (OFF > 0) {
    if constexpr (n > 1) {
      constexpr int h = n / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int k = 0; k < h; ++k) {
        const float send = up ? v[k] : v[k + h];
        const float keep = up ? v[k + h] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += h;
      warp_split_sum<N2, h, OFF / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      warp_split_sum<N2, 1, OFF / 2>(v, lane, base);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// acc += the VW floats at p (one 16-byte load when VW = 4), read from L2
template <int VW>
__device__ __forceinline__ void add_l2(float (&acc)[VW],
                                       const float* __restrict__ p) {
  if constexpr (VW == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    acc[0] += f.x;
    acc[1] += f.y;
    acc[2] += f.z;
    acc[3] += f.w;
  } else {
    acc[0] += __ldcg(p);
  }
}

// Q_bar from each thread's w_i DF_i (zero past B) in v: the warp's sums,
// the block's warps in order, one partial a block.  The last block to take
// the ticket sums the partials: a thread takes VW columns of every
// groups-th block with U sums of its own (U loads in flight), adds them
// in order, and the groups' sums meet in a fixed tree; it then resets the
// ticket.  Every order depends only on (gridDim, blockDim).
template <int A, int N2>
__device__ __forceinline__ void qbar_reduce(float (&v)[N2],
                                            float* __restrict__ part,
                                            unsigned int* __restrict__ ticket,
                                            float* __restrict__ qbar) {
  constexpr int N = A * A;
  constexpr int NPER = N2 >= 32 ? N2 / 32 : 1;      // sums a lane ends with
  constexpr int SPREAD = N2 >= 32 ? 1 : 32 / N2;    // lanes holding each
  constexpr int VW = N % 4 == 0 ? 4 : 1;            // floats a load
  constexpr int NV = N / VW;                        // loads a partial
  constexpr int U = 8;
  // per-warp sums, then the last block's group sums (blockDim * VW)
  constexpr int RED = kMaxThreads / 32 * N2 > kMaxThreads * VW
                          ? kMaxThreads / 32 * N2 : kMaxThreads * VW;
  __shared__ float red[RED];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  int base = 0;
  warp_split_sum<N2, N2, 16>(v, lane, base);
  if (lane % SPREAD == 0) {
#pragma unroll
    for (int r = 0; r < NPER; ++r) red[warp * N2 + base + r] = v[r];
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (t < N) {
    float s = red[t];
    for (int w = 1; w < nwarps; ++w) s += red[w * N2 + t];
    part[(size_t)blockIdx.x * N + t] = s;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int groups = blockDim.x / NV, nb = gridDim.x;
  const int grp = t / NV, col = (t % NV) * VW;
  if (grp < groups) {
    float acc[U][VW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < VW; ++w) acc[u][w] = 0.f;
    }
    int k = grp;
    for (; k + (U - 1) * groups < nb; k += U * groups) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        add_l2<VW>(acc[u], part + (size_t)(k + u * groups) * N + col);
    }
#pragma unroll
    for (int u = 0; u < U - 1; ++u) {
      if (k + u * groups < nb)
        add_l2<VW>(acc[u], part + (size_t)(k + u * groups) * N + col);
    }
#pragma unroll
    for (int u = 1; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < VW; ++w) acc[0][w] += acc[u][w];
    }
#pragma unroll
    for (int w = 0; w < VW; ++w) red[grp * N + col + w] = acc[0][w];
  }
  __syncthreads();
  for (int s = 1; s < groups; s *= 2) {
    if (grp < groups && grp % (2 * s) == 0 && grp + s < groups) {
#pragma unroll
      for (int w = 0; w < VW; ++w)
        red[grp * N + col + w] += red[(grp + s) * N + col + w];
    }
    __syncthreads();
  }
  if (t < N) qbar[t] = red[t];
  if (t == 0) *ticket = 0u;        // ready for the next launch on the stream
}

// 64 registers a thread (24 bytes spilled; 32 warps an SM at A = 4): on
// an H100 14% quicker than the 122 it takes unconstrained (16 warps)
template <int A, int ORDER, int SQ>
__global__ void __launch_bounds__(kMaxThreads, 2) expm_bwd_kernel(
    const float* __restrict__ Q, const float* __restrict__ b,
    const float* __restrict__ P, const float* __restrict__ g,
    float* __restrict__ part, unsigned int* __restrict__ ticket,
    float* __restrict__ qbar, float* __restrict__ bbar, int B, int order,
    int squarings) {
  constexpr int N = A * A;
  constexpr int N2 = pow2_at_least(N);
  __shared__ Uniform<A> u;
  const int t = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + t;
  float bi = 0.f, Pv[N], E[N];               // in flight across the barrier
  if (i < B) {
    bi = b[i];
    load_row<A>(P + (size_t)i * N, Pv);
    load_row<A>(g + (size_t)i * N, E);
  }
  load_uniform<A>(Q, u);
  __syncthreads();
  float v[N2];
#pragma unroll
  for (int c = 0; c < N2; ++c) v[c] = 0.f;
  if (i < B) {
    float R[N], Qr[N], field[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      R[c] = u.R[c];
      Qr[c] = u.Q[c];
    }
    bbar[i] = bwd_element<A, ORDER, SQ>(R, Qr, u.mu, u.clampv, bi, Pv, E,
                                        field, order, squarings);
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = field[c];
  }
  qbar_reduce<A>(v, part, ticket, qbar);
}

// the wrapper's plan (models/expm_kernel.py::expm_plan), checked
bool plan_ok(int B, int A, int order, int squarings, int threads,
             int blocks) {
  return A >= 1 && A <= 8 && order >= 1 && order <= kMaxOrder &&
         squarings >= 0 && squarings <= 64 && threads % 32 == 0 &&
         threads >= kMinThreads && threads <= kMaxThreads &&
         blocks == (B + threads - 1) / threads;
}

// the alphabet with a compile-time (12, 12) instance: every path that
// reaches K4 runs 4 states (DNA, and a rate mixture's 4-state blocks)
constexpr int kUnrolledA = 4;

template <int A>
void launch_fwd(const float* Q, const float* b, float* P, int B, int order,
                int squarings, int threads, int blocks, cudaStream_t st) {
  if constexpr (A == kUnrolledA) {
    if (order == 12 && squarings == 12) {
      expm_fwd_kernel<A, 12, 12><<<blocks, threads, 0, st>>>(
          Q, b, P, B, order, squarings);
      return;
    }
  }
  expm_fwd_kernel<A, 0, 0><<<blocks, threads, 0, st>>>(Q, b, P, B, order,
                                                       squarings);
}

template <int A>
void launch_bwd(const float* Q, const float* b, const float* P,
                const float* g, float* part, unsigned int* ticket,
                float* qbar, float* bbar, int B, int order, int squarings,
                int threads, int blocks, cudaStream_t st) {
  if constexpr (A == kUnrolledA) {
    if (order == 12 && squarings == 12) {
      expm_bwd_kernel<A, 12, 12><<<blocks, threads, 0, st>>>(
          Q, b, P, g, part, ticket, qbar, bbar, B, order, squarings);
      return;
    }
  }
  expm_bwd_kernel<A, 0, 0><<<blocks, threads, 0, st>>>(
      Q, b, P, g, part, ticket, qbar, bbar, B, order, squarings);
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

extern "C" int launch_expm_fwd(const float* Q, const float* b, float* P,
                               int B, int A, int order, int squarings,
                               int threads, int blocks, void* stream) {
  if (B <= 0) return 0;
  if (!plan_ok(B, A, order, squarings, threads, blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_FWD(AA)                                                      \
  case AA:                                                                 \
    launch_fwd<AA>(Q, b, P, B, order, squarings, threads, blocks, st);     \
    break;
    PHYLO_A_CASES(PHYLO_FWD)
#undef PHYLO_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// part: (blocks, A*A) scratch; ticket: one counter, 0 between launches
// (the last block resets it); qbar (A, A); bbar (B,)
extern "C" int launch_expm_bwd(const float* Q, const float* b,
                               const float* P, const float* g, float* part,
                               unsigned int* ticket, float* qbar,
                               float* bbar, int B, int A, int order,
                               int squarings, int threads, int blocks,
                               void* stream) {
  if (B <= 0) return 0;
  if (!plan_ok(B, A, order, squarings, threads, blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (A) {
#define PHYLO_BWD(AA)                                                      \
  case AA:                                                                 \
    launch_bwd<AA>(Q, b, P, g, part, ticket, qbar, bbar, B, order,         \
                   squarings, threads, blocks, st);                        \
    break;
    PHYLO_A_CASES(PHYLO_BWD)
#undef PHYLO_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
