// Kernel K5 of phylo_tpu_torch: K multinomial ancestor draws by
// Gumbel-max over a counter-based random field.
//
// Replaces phylo_tpu/smc/resample_kernel.py::categorical_pallas (Pallas
// body _kernel, which used the TPU's hardware PRNG).
//
// Draw i takes argmax_j logits[j] - log(-log(u_ij)), ties to the lowest
// index, with u_ij = (n + 0.5) / 2^23 from the top 23 bits n of word
// j % 4 of Philox4x32-10(counter = (j / 4, i, 0, 0), key = (seed[0],
// seed[1]) low 32 bits).  The plain version in
// phylo_tpu_torch/smc/resample_kernel.py computes the same words.
//
// What bounds it on an H100: operations.  The (K, K) field (4.2 M
// entries at K = 2048) is never stored: per entry the kernel spends a
// quarter of a Philox call (10 rounds of two 32-bit multiplies) and two
// logf, against 8 KB of logits read and 8 KB of indices written.
//
// Design: one block per draw; each thread generates four entries per
// Philox call, keeps its running (max, index) and the block reduces
// them with warp shuffles and shared memory, preferring the lower index
// on ties.  The key comes from a (2,) int64 device tensor drawn from the
// run's torch.Generator, so the host never waits.  Every entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t (&c)[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ bool better(float s, int j, float best, int bj) {
  return s > best || (s == best && j < bj);
}

__global__ void __launch_bounds__(kThreads) categorical_kernel(
    const float* __restrict__ logits, const long long* __restrict__ seed,
    int* __restrict__ out, int K) {
  __shared__ float sh_best[32];
  __shared__ int sh_idx[32];
  const int i = blockIdx.x;
  const uint32_t k0 = (uint32_t)(seed[0] & 0xffffffffLL);
  const uint32_t k1 = (uint32_t)(seed[1] & 0xffffffffLL);
  float best = -CUDART_INF_F;
  int bj = K;
  const int n4 = (K + 3) / 4;
  for (int j4 = threadIdx.x; j4 < n4; j4 += blockDim.x) {
    uint32_t c[4] = {(uint32_t)j4, (uint32_t)i, 0u, 0u};
    philox4x32_10(c, k0, k1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * j4 + t;
      if (j < K) {
        const float u =
            ((float)(c[t] >> 9) + 0.5f) * (1.0f / 8388608.0f);
        const float s = logits[j] - logf(-logf(u));
        if (better(s, j, best, bj)) {
          best = s;
          bj = j;
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o);
    const int oj = __shfl_down_sync(0xffffffffu, bj, o);
    if (better(ob, oj, best, bj)) {
      best = ob;
      bj = oj;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    sh_best[warp] = best;
    sh_idx[warp] = bj;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < nwarps ? sh_best[lane] : -CUDART_INF_F;
    bj = lane < nwarps ? sh_idx[lane] : K;
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, o);
      const int oj = __shfl_down_sync(0xffffffffu, bj, o);
      if (better(ob, oj, best, bj)) {
        best = ob;
        bj = oj;
      }
    }
    if (lane == 0) out[i] = bj < K ? bj : 0;
  }
}

}  // namespace

extern "C" int launch_categorical(const float* logits, const long long* seed,
                                  int* out, int K, void* stream) {
  if (K <= 0) return 0;
  categorical_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, seed, out, K);
  return (int)cudaGetLastError();
}
