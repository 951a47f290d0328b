// Kernel K5 of phylo_tpu_torch: K multinomial ancestor draws by inverse
// CDF in exact integer arithmetic, one block, one launch.
//
// Replaces phylo_tpu/smc/resample_kernel.py::categorical_pallas (Pallas
// body _kernel: a (K, K) Gumbel field from the TPU's hardware PRNG, which
// suits the TPU's vector unit; a scan and a data-dependent search do
// not).  K iid draws need K uniforms, not K^2, and on this card a
// block-wide scan and a binary search in shared memory are native.
//
// The steps (the plain version in phylo_tpu_torch/smc/resample_kernel.py
// takes the same ones in torch):
//  1. lmax = max_j logits_j;
//  2. w_j = expf(l_j - lmax) (0 for l_j = -inf), q_j = floor(w_j 2^E) as
//     int64, E = 52 - ceil(log2 K), so Q = sum_j q_j <= 2^52;
//  3. C = the inclusive prefix sum of q: exact, so any order gives the
//     plain version's cumsum;
//  4. draw i: r_i = the top 52 bits of words (2h, 2h + 1), h = i % 2, of
//     Philox4x32-10(counter = (i / 2, 0, 0, 0), key = (seed[0], seed[1])
//     low 32 bits); x_i = floor(((r_i + 0.5) / 2^52) Q) in float64 (one
//     rounding); the draw is the first j with C_j > x_i (a binary search),
//     or 0 when every logit is -inf (Q = 0).
// So j is drawn with probability q_j / Q (to 2^-52), within 2^-E / w_j
// relative of softmax(logits); a particle more than E ln 2 nats below
// the max (28 at K = 2048) has q_j = 0 and is never drawn.
//
// What bounds it on an H100: latency.  It reads 4 K bytes and writes
// 4 K (8 KB each at K = 2048) and does about 20 integer multiplies and
// log2 K search steps a draw: the byte bound is a few nanoseconds, so the
// time is the launch and the block's dependent steps (a max, a scan, a
// search).  Design: one block of up to 1024 threads, each a contiguous
// segment of ceil(K / threads) particles for steps 2-3 and every
// threads-th pair of draws for step 4; C in shared memory up to
// kCdfSmemMax particles (8 bytes each), above that in a global scratch
// row the wrapper allocates.  The key comes from a (2,) int64 device
// tensor drawn from the run's torch.Generator, so the host never waits.
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCdfSmemMax = 28672;  // particles whose C fits shared memory

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

__global__ void __launch_bounds__(kMaxThreads) categorical_kernel(
    const float* __restrict__ logits, const long long* __restrict__ seed,
    int* __restrict__ out, long long* __restrict__ scratch, int K, int E) {
  extern __shared__ long long cdf_smem[];
  __shared__ float fred[32];
  __shared__ long long lred[32];
  long long* cdf = scratch ? scratch : cdf_smem;
  const int tid = threadIdx.x, NT = blockDim.x, NW = NT >> 5;
  const int lane = tid & 31, wid = tid >> 5;
  // the bits of the thread's first pair of draws need no weights: their
  // Philox call overlaps the loads and barriers of steps 1-3
  const uint32_t k0 = (uint32_t)(seed[0] & 0xffffffffLL);
  const uint32_t k1 = (uint32_t)(seed[1] & 0xffffffffLL);
  uint32_t c[4] = {(uint32_t)tid, 0u, 0u, 0u};
  philox4x32_10(c, k0, k1);

  // 1. lmax over the block, each thread over its segment of step 2
  const int per = (K + NT - 1) / NT;
  const int j0 = min(tid * per, K), j1 = min(j0 + per, K);
  float m = -CUDART_INF_F;
  for (int j = j0; j < j1; ++j) m = fmaxf(m, logits[j]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) fred[wid] = m;
  __syncthreads();
  float lmax = fred[0];
  for (int q = 1; q < NW; ++q) lmax = fmaxf(lmax, fred[q]);

  // 2. q_j over the thread's segment, with its running sums
  const float two_e = __int_as_float((127 + E) << 23);  // 2^E, exact
  long long run = 0;
  for (int j = j0; j < j1; ++j) {
    const float l = logits[j];
    const float wj = l > -CUDART_INF_F ? expf(l - lmax) : 0.f;
    run += (long long)floorf(wj * two_e);
    cdf[j] = run;
  }

  // 3. the segments' offsets: an exclusive scan of their totals
  long long incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) lred[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    long long t = lane < NW ? lred[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < NW) lred[lane] = t;
  }
  __syncthreads();
  const long long off = incl - run + (wid ? lred[wid - 1] : 0);
  for (int j = j0; j < j1; ++j) cdf[j] += off;
  __syncthreads();
  const double dq = (double)cdf[K - 1];

  // 4. two draws a Philox call, each a binary search of C
  for (int p = tid; 2 * p < K; p += NT) {
    if (p != tid) {
      c[0] = (uint32_t)p;
      c[1] = c[2] = c[3] = 0u;
      philox4x32_10(c, k0, k1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * p + h;
      if (i < K) {
        const unsigned long long r =
            ((unsigned long long)c[2 * h] << 20) | (c[2 * h + 1] >> 12);
        const double x = __dmul_rn(
            __dmul_rn(__dadd_rn((double)r, 0.5), 1.0 / 4503599627370496.0),
            dq);
        const long long xi = (long long)floor(x);
        int lo = 0, hi = K;             // the first j with C_j > x_i
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf[mid] > xi)
            hi = mid;
          else
            lo = mid + 1;
        }
        out[i] = lo < K ? lo : 0;
      }
    }
  }
}

}  // namespace

// scratch: a (K,) int64 row when K > kCdfSmemMax, else null; E = 52 -
// ceil(log2 K).
extern "C" int launch_categorical(const float* logits, const long long* seed,
                                  int* out, long long* scratch, int K, int E,
                                  void* stream) {
  if (K <= 0) return 0;
  if (E < 1 || E > 52 || (K > kCdfSmemMax && !scratch))
    return (int)cudaErrorInvalidValue;
  const int pairs = (K + 1) / 2;
  int threads = (pairs + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = scratch ? 0 : (size_t)K * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        categorical_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  categorical_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      logits, seed, out, scratch, K, E);
  return (int)cudaGetLastError();
}
