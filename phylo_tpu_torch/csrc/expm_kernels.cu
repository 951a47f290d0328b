// Kernel K4 of phylo_tpu_torch: the uniformized delta-form expm chain
// and its Frechet-adjoint backward for a shared A x A rate matrix.
//
// Replaces phylo_tpu/models/expm_kernel.py::_fwd_impl (Pallas body
// _expm_fwd_kernel) and ::_bwd_impl (body _expm_bwd_kernel).
//
// Forward, per batch element i with branch length b_i:
//   b_eff = min(b, 80 / mu), x = mu b_eff / 2^s,
//   S = xR / order;  S <- (xR / j) (I + S) for j = order-1 .. 1;
//   D = S;  D <- 2 D + D D  (s times);  P = e^{-mu b_eff} (I + D).
// Backward: the same chain on the block pair (T, F) of
//   [[x R^T, Pbar / 2^s], [0, x R^T]],  (T1, F1)(T2, F2) = (T1 T2,
//   T1 F2 + F1 T2), and the output field is b_eff e^{-mu b_eff} F.
//
// What bounds it on an H100: operations, not bytes.  Per element the
// forward does (order - 1 + squarings) = 23 dense A x A products
// (23 * 64 FMAs at A = 4) against 4 + 64 bytes of traffic; the backward
// three products per step.  Everything stays in registers.
//
// Design: one thread per batch element with the whole chain in
// registers (16 floats of state forward, 32 for the (T, F) pair
// backward); R and mu arrive as one small array [R (A*A), mu].  Exact
// FP32 FMAs, no tensor cores.  The backward writes the per-element
// field and the caller reduces it with torch.sum; b_bar is computed
// outside the kernel.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int A>
__device__ __forceinline__ void mm(const float (&a)[A * A],
                                   const float (&b)[A * A],
                                   float (&c)[A * A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = 0; j < A; ++j) {
      float acc = a[i * A] * b[j];
#pragma unroll
      for (int m = 1; m < A; ++m) acc += a[i * A + m] * b[m * A + j];
      c[i * A + j] = acc;
    }
  }
}

template <int A>
__device__ __forceinline__ void add_eye(const float (&s)[A * A],
                                        float (&o)[A * A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = 0; j < A; ++j)
      o[i * A + j] = s[i * A + j] + (i == j ? 1.f : 0.f);
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads) expm_fwd_kernel(
    const float* __restrict__ Rmu, const float* __restrict__ b,
    float* __restrict__ P, int B, int order, int squarings) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float mu = Rmu[A * A];
  const float beff = fminf(b[i], 80.0f / mu);
  const float x = (mu * beff) / exp2f((float)squarings);
  float xR[A * A], S[A * A], T1[A * A], T2[A * A];
#pragma unroll
  for (int c = 0; c < A * A; ++c) {
    xR[c] = Rmu[c] * x;
    S[c] = xR[c] / (float)order;
  }
  for (int j = order - 1; j >= 1; --j) {
#pragma unroll
    for (int c = 0; c < A * A; ++c) T1[c] = xR[c] / (float)j;
    add_eye<A>(S, T2);
    mm<A>(T1, T2, S);
  }
  for (int q = 0; q < squarings; ++q) {
    mm<A>(S, S, T1);
#pragma unroll
    for (int c = 0; c < A * A; ++c) S[c] = 2.f * S[c] + T1[c];
  }
  const float sc = expf(-mu * beff);
  add_eye<A>(S, T1);
#pragma unroll
  for (int c = 0; c < A * A; ++c) P[(size_t)i * A * A + c] = sc * T1[c];
}

template <int A>
__global__ void __launch_bounds__(kThreads) expm_bwd_kernel(
    const float* __restrict__ Rmu, const float* __restrict__ b,
    const float* __restrict__ g, float* __restrict__ out, int B, int order,
    int squarings) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float mu = Rmu[A * A];
  const float beff = fminf(b[i], 80.0f / mu);
  const float x = (mu * beff) / exp2f((float)squarings);
  const float inv = 1.0f / exp2f((float)squarings);
  float xT[A * A], E[A * A], ST[A * A], SF[A * A];
  float Tj[A * A], Ej[A * A], IT[A * A], t1[A * A], t2[A * A];
#pragma unroll
  for (int r = 0; r < A; ++r) {
#pragma unroll
    for (int c = 0; c < A; ++c) {
      xT[r * A + c] = Rmu[c * A + r] * x;  // the chain runs at (Q b)^T
      E[r * A + c] = g[(size_t)i * A * A + r * A + c] * inv;
    }
  }
#pragma unroll
  for (int c = 0; c < A * A; ++c) {
    ST[c] = xT[c] / (float)order;
    SF[c] = E[c] / (float)order;
  }
  for (int j = order - 1; j >= 1; --j) {
#pragma unroll
    for (int c = 0; c < A * A; ++c) {
      Tj[c] = xT[c] / (float)j;
      Ej[c] = E[c] / (float)j;
    }
    add_eye<A>(ST, IT);
    mm<A>(Tj, SF, t1);
    mm<A>(Ej, IT, t2);
#pragma unroll
    for (int c = 0; c < A * A; ++c) SF[c] = t1[c] + t2[c];
    mm<A>(Tj, IT, ST);
  }
  for (int q = 0; q < squarings; ++q) {
    mm<A>(ST, SF, t1);   // T F
    mm<A>(SF, ST, t2);   // F T
#pragma unroll
    for (int c = 0; c < A * A; ++c) SF[c] = 2.f * SF[c] + t1[c] + t2[c];
    mm<A>(ST, ST, t1);   // T T
#pragma unroll
    for (int c = 0; c < A * A; ++c) ST[c] = 2.f * ST[c] + t1[c];
  }
  const float wgt = beff * expf(-mu * beff);
#pragma unroll
  for (int c = 0; c < A * A; ++c) out[(size_t)i * A * A + c] = wgt * SF[c];
}

}  // namespace

#define PHYLO_A_CASES(MACRO) \
  MACRO(1) MACRO(2) MACRO(3) MACRO(4) MACRO(5) MACRO(6) MACRO(7) MACRO(8)

extern "C" int launch_expm_fwd(const float* Rmu, const float* b, float* P,
                               int B, int A, int order, int squarings,
                               void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (B + kThreads - 1) / kThreads;
  switch (A) {
#define PHYLO_FWD(AA)                                                      \
  case AA:                                                                 \
    expm_fwd_kernel<AA><<<nb, kThreads, 0, st>>>(Rmu, b, P, B, order,     \
                                                 squarings);               \
    break;
    PHYLO_A_CASES(PHYLO_FWD)
#undef PHYLO_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_expm_bwd(const float* Rmu, const float* b,
                               const float* g, float* out, int B, int A,
                               int order, int squarings, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (B + kThreads - 1) / kThreads;
  switch (A) {
#define PHYLO_BWD(AA)                                                      \
  case AA:                                                                 \
    expm_bwd_kernel<AA><<<nb, kThreads, 0, st>>>(Rmu, b, g, out, B, order, \
                                                 squarings);               \
    break;
    PHYLO_A_CASES(PHYLO_BWD)
#undef PHYLO_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
