// The symmetric eigendecomposition of phylo_tpu_torch's spectral
// transitions (models.expm.expm_reversible): S = U diag(w) U^T for a
// batch of float64 A x A symmetric matrices, A <= 64, by the
// parallel-ordered cyclic Jacobi method, run to convergence inside the
// kernel.
//
// Replaces no Pallas kernel: the JAX package calls jnp.linalg.eigh
// (phylo_tpu/models/expm.py:308, and eigvalsh at :324 for its eigengap
// probe), which XLA runs without a host round trip.  PyTorch's
// torch.linalg.eigh on a CUDA tensor checks its solver's status on the
// host, so it cannot sit inside a CUDA graph; this kernel can.
//
// Method, per matrix (one thread block each):
//   A <- S (padded with a zero row and column to an even order n_p),
//   V <- I;  sweep until a sweep applies no rotation (at most
//   max_sweeps, 40 from the wrapper):
//     for each of the n_p - 1 rounds of the round-robin (circle) order,
//     n_p / 2 disjoint pairs (p, q) at once:
//       t = sign(d) h / (|d| + sqrt(d^2 + h^2)), d = a_qq - a_pp,
//       h = 2 a_pq (Golub & Van Loan's sym.schur2, its tau = d / h
//       multiplied through), c = 1 / sqrt(1 + t^2), s = t c, skipped
//       (c = 1, s = 0) where |a_pq| <= 1e-18 ||S||_F;
//       A <- J^T A J,  V <- V J  with J the pairs' rotations;
//   w = diag(A) sorted ascending (ties by index, NaN last), U = V's
//   columns in the same order.
// A NaN or an infinity anywhere in S makes every output NaN (and the
// sweeps 0): no error, where torch.linalg.eigh gives NaN or raises.  A
// matrix whose last allowed sweep still rotated has not converged: its
// w and U are NaN too (its sweeps max_sweeps), so a capped matrix shows
// in the transitions on the device, with no flag for the host to read.
// A rotation's diagonal block takes the exact closed form (a_pp - t a_pq,
// a_qq + t a_pq, zero off-diagonal), written by the thread that forms the
// rotation (no other reads those entries in that phase); every other 2 x 2
// block (k, l) of the round is rows-then-columns, computed once for k < l
// by one thread and written to both (k, l) and (l, k), so A stays exactly
// symmetric.  Off-diagonal entries
// only ever mix with off-diagonal entries, so the sweeps converge
// quadratically to zero without a floor of rounding noise.  No atomics:
// the result is the same bits on every call.
//
// What bounds it on an H100: neither bytes (2 A^2 + A doubles in and
// out: 66 KB at A = 64) nor FP64 operations (a sweep is about 9 n_p^3
// flops, ~2.4 MFLOP at n_p = 64, ten sweeps ~0.7 us at the card's
// 34 TFLOP/s FP64 outside the tensor cores): one block runs a chain of
// 2 (n_p - 1) barrier-separated phases a sweep, so the time is the
// barriers' and the shared-memory round trips' latency.  So a round is two phases, not
// three: the first warp forms the round's rotations (one square root,
// one division and one reciprocal square root each) and updates their
// diagonal blocks while the other 15 warps apply the previous round's
// rotations to V (double-buffered rotation arrays); then each of the
// m (m - 1) / 2 off-diagonal blocks of A is one thread's, its indices
// fixed for the whole run.  A and V live in shared memory (2 x 64 x 64
// x 8 B = 64 KB, dynamic, opted in above 48 KB).  One matrix a call on
// the main path, so one SM works.  (A first design, three phases a round
// with V in the third and the rotations from tau, took 1.44 ms at
// GY94's 61 states on an H100; PERF.md.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 512;
constexpr double kTolScale = 1e-18;

// the round-robin order: round r of n_p - 1 pairs player n_p - 1 with r
// and (r + k) with (r - k) modulo n_p - 1 for k = 1 .. n_p / 2 - 1
__device__ __forceinline__ void round_pair(int r, int k, int np, int* p,
                                           int* q) {
  int a, b;
  if (k == 0) {
    a = np - 1;
    b = r;
  } else {
    const int m = np - 1;
    a = (r + k) % m;
    b = (r - k + m) % m;
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

// the t of the rotation that zeroes a_pq of [[a_pp, a_pq], [a_pq, a_qq]]:
// t = sign(d) h / (|d| + sqrt(d^2 + h^2)), d = a_qq - a_pp, h = 2 a_pq
// (sym.schur2's smaller root, tau = d / h, multiplied through by |h|: one
// square root and one division)
__device__ __forceinline__ double rotation_t(double app, double aqq,
                                             double apq) {
  const double d = aqq - app, h = 2.0 * apq;
  const double t = h / (fabs(d) + sqrt(fma(d, d, h * h)));
  return d < 0.0 ? -t : t;
}

// whether (x, j) comes before (y, i) in the ascending order: numbers by
// value, NaN after them all, equal keys by index; a strict total order,
// so the ranks are a permutation whatever the diagonal holds
__device__ __forceinline__ bool sorts_before(double x, int j, double y,
                                             int i) {
  const bool nx = isnan(x), ny = isnan(y);
  if (nx != ny) return ny;
  if (nx) return j < i;
  return x < y || (x == y && j < i);
}

__global__ void __launch_bounds__(kThreads)
    jacobi_eigh_kernel(const double* __restrict__ S, double* __restrict__ w,
                       double* __restrict__ U, int* __restrict__ sweeps,
                       int n, int np, int max_sweeps) {
  extern __shared__ double smem[];
  double* a = smem;             // np x np, row-major
  double* v = smem + np * np;   // np x np, row-major
  // a round's rotations, double-buffered: V takes round g's while the
  // first warp forms round g + 1's
  __shared__ double rc[2][kMaxN / 2], rs[2][kMaxN / 2];
  __shared__ int rp[2][kMaxN / 2], rq[2][kMaxN / 2], inv[kMaxN];
  __shared__ double warp_sums[kThreads / 32];
  __shared__ int rotated;
  const int tid = threadIdx.x;
  const int m = np / 2;
  const double* Sm = S + (size_t)blockIdx.x * n * n;

  double sq = 0.0;
  int bad = 0;
  for (int e = tid; e < np * np; e += kThreads) {
    const int i = e / np, j = e - (e / np) * np;
    const double x = (i < n && j < n) ? Sm[i * n + j] : 0.0;
    a[e] = x;
    v[e] = i == j ? 1.0 : 0.0;
    sq = fma(x, x, sq);
    bad |= !isfinite(x);
  }
  // a NaN or an infinity in S: every output NaN, as eigh of it is
  // undefined (the threshold would be non-finite and skip every rotation)
  if (__syncthreads_or(bad)) {
    const double kNaN = __longlong_as_double(0x7ff8000000000000LL);
    for (int e = tid; e < n * n; e += kThreads)
      U[(size_t)blockIdx.x * n * n + e] = kNaN;
    if (tid < n) w[(size_t)blockIdx.x * n + tid] = kNaN;
    if (tid == 0) sweeps[blockIdx.x] = 0;
    return;
  }
  // ||S||_F: a fixed xor-shuffle tree a warp, then the warps in order
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sq;
  __syncthreads();
  double fro2 = 0.0;
  for (int i = 0; i < kThreads / 32; ++i) fro2 += warp_sums[i];
  const double tol = kTolScale * sqrt(fro2);

  // this thread's off-diagonal block (k, l), k < l, of every round: the
  // m (m - 1) / 2 <= 496 blocks one a thread
  int bk = -1, bl = -1;
  for (int k = 0, e = tid; k < m - 1; e -= m - 1 - k, ++k) {
    if (e < m - 1 - k) {
      bk = k;
      bl = k + 1 + e;
      break;
    }
  }
  // this thread's V entries (row i, column pair l) for warps 1..: at most
  // kVItems a thread, as row offsets and pair indices
  constexpr int kVThreads = kThreads - 32;
  constexpr int kVItems = (kMaxN * kMaxN / 2 + kVThreads - 1) / kVThreads;
  int vrow[kVItems], vpair[kVItems];
#pragma unroll
  for (int j = 0; j < kVItems; ++j) {
    const int e = tid - 32 + j * kVThreads;
    const bool on = tid >= 32 && e < n * m;
    vrow[j] = on ? (e / m) * np : -1;
    vpair[j] = on ? e - (e / m) * m : 0;
  }

  int sweep = 0, g = 0;      // g: rounds so far, over every sweep
  bool converged = false;
  while (sweep < max_sweeps) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    ++sweep;
    for (int r = 0; r < np - 1; ++r, ++g) {
      const int cur = g & 1;
      if (tid < 32) {
        // round g's rotations and their diagonal blocks: rotation k alone
        // reads and writes a_pp, a_qq and a_pq
        if (tid < m) {
          int p, q;
          round_pair(r, tid, np, &p, &q);
          const double apq = a[p * np + q];
          double c = 1.0, s = 0.0;
          if (fabs(apq) > tol) {
            const double t = rotation_t(a[p * np + p], a[q * np + q], apq);
            c = rsqrt(fma(t, t, 1.0));
            s = t * c;
            a[p * np + p] -= t * apq;
            a[q * np + q] += t * apq;
            a[p * np + q] = 0.0;
            a[q * np + p] = 0.0;
            rotated = 1;
          }
          rp[cur][tid] = p;
          rq[cur][tid] = q;
          rc[cur][tid] = c;
          rs[cur][tid] = s;
        }
      } else if (g > 0) {
        // V <- V J of round g - 1
        const int prev = cur ^ 1;
#pragma unroll
        for (int j = 0; j < kVItems; ++j) {
          if (vrow[j] < 0) continue;
          const int l = vpair[j];
          const int pl = rp[prev][l], ql = rq[prev][l];
          const double cl = rc[prev][l], sl = rs[prev][l];
          const double vp = v[vrow[j] + pl], vq = v[vrow[j] + ql];
          v[vrow[j] + pl] = cl * vp - sl * vq;
          v[vrow[j] + ql] = sl * vp + cl * vq;
        }
      }
      __syncthreads();
      // A <- J^T A J on the off-diagonal blocks, rows then columns; the
      // mirror block (l, k) is written as the transpose
      if (bk >= 0) {
        const int pk = rp[cur][bk], qk = rq[cur][bk];
        const int pl = rp[cur][bl], ql = rq[cur][bl];
        const double ck = rc[cur][bk], sk = rs[cur][bk];
        const double cl = rc[cur][bl], sl = rs[cur][bl];
        const double x = a[pk * np + pl], y = a[pk * np + ql];
        const double z = a[qk * np + pl], u = a[qk * np + ql];
        const double x1 = ck * x - sk * z, z1 = sk * x + ck * z;
        const double y1 = ck * y - sk * u, u1 = sk * y + ck * u;
        const double x2 = cl * x1 - sl * y1, y2 = sl * x1 + cl * y1;
        const double z2 = cl * z1 - sl * u1, u2 = sl * z1 + cl * u1;
        a[pk * np + pl] = x2;
        a[pk * np + ql] = y2;
        a[qk * np + pl] = z2;
        a[qk * np + ql] = u2;
        a[pl * np + pk] = x2;
        a[ql * np + pk] = y2;
        a[pl * np + qk] = z2;
        a[ql * np + qk] = u2;
      }
      __syncthreads();
    }
    const int any = rotated;
    __syncthreads();
    if (!any) {
      converged = true;
      break;
    }
  }
  // the cap reached with rotations still applied: NaN out, as for a
  // non-finite S (the block agrees on `converged`, read from `rotated`)
  if (!converged) {
    const double kNaN = __longlong_as_double(0x7ff8000000000000LL);
    for (int e = tid; e < n * n; e += kThreads)
      U[(size_t)blockIdx.x * n * n + e] = kNaN;
    if (tid < n) w[(size_t)blockIdx.x * n + tid] = kNaN;
    if (tid == 0) sweeps[blockIdx.x] = sweep;
    return;
  }
  // the last round's V update
  if (g > 0) {
    const int prev = (g - 1) & 1;
    for (int e = tid; e < n * m; e += kThreads) {
      const int i = e / m, l = e - (e / m) * m;
      const int pl = rp[prev][l], ql = rq[prev][l];
      const double cl = rc[prev][l], sl = rs[prev][l];
      const double vp = v[i * np + pl], vq = v[i * np + ql];
      v[i * np + pl] = cl * vp - sl * vq;
      v[i * np + ql] = sl * vp + cl * vq;
    }
  }
  __syncthreads();

  // eigenvalues ascending (ties by index, NaN after every number),
  // eigenvectors as columns: the ranks are a permutation whatever the
  // diagonal holds
  if (tid < n) {
    const double wi = a[tid * np + tid];
    int rank = 0;
    for (int j = 0; j < n; ++j)
      rank += sorts_before(a[j * np + j], j, wi, tid);
    inv[rank] = tid;
    w[(size_t)blockIdx.x * n + rank] = wi;
  }
  __syncthreads();
  double* Um = U + (size_t)blockIdx.x * n * n;
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - (e / n) * n;
    Um[e] = v[i * np + inv[j]];
  }
  if (tid == 0) sweeps[blockIdx.x] = sweep;
}

}  // namespace

// S (batch, n, n) float64, symmetric -> w (batch, n) ascending, U (batch,
// n, n) with U[:, :, j] the eigenvector of w[:, j], and the sweeps each
// matrix took (batch,) int32; a matrix not converged within max_sweeps
// sweeps gives NaN in its w and U.  1 <= n <= 64, max_sweeps >= 1.
extern "C" int launch_eigh_jacobi(const double* S, double* w, double* U,
                                  int* sweeps, int batch, int n,
                                  int max_sweeps, void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || n > kMaxN || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  const int np = n + (n & 1);
  const size_t smem = 2 * (size_t)np * np * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  jacobi_eigh_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(S, w, U, sweeps,
                                                            n, np,
                                                            max_sweeps);
  return (int)cudaGetLastError();
}
