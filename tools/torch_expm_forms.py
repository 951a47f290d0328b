"""Kernel K4's forms on the card, each held to the launcher's form and
timed against it in turns, plus each K4 kernel's registers, local memory
and resident warps.

    python tools/torch_expm_forms.py [--ptxas]

Builds expm_kernels.cu (with --ptxas, prints nvcc's registers, shared
memory and spills per kernel) and a shim that includes it and adds the
forms below, then at primate VCSMC's 45,056 matrices, DS1 GTR+G4's
425,984 and the twist's DS1 rank-0 898,560 and last-rank 7,680
(chip_smoke.py's inputs):
* block size: the forward and the backward at 64, 128, 256 and 512
  threads
  (`expm_plan` picks one of the first three; BWD_LARGE_THREADS is the
  backward's at large batches);
* where R lives: R, Q, mu and 80 / mu in the constant bank, filled by an
  on-stream device-to-device copy from torch's uniformize (the copy not
  timed), against the launcher's R computed a block into shared memory
  and loaded once a thread;
* the compile-time (12, 12) instance against the generic one run at
  (12, 12);
* the forward's P staged through shared memory and stored by the block
  as consecutive float4s, against each thread's own four float4 stores;
* register budgets (`__launch_bounds__` blocks of 512 threads an SM):
  the backward at 128 or 42 registers, the forward at 64 or 42, against
  the launcher's 64 and 32.
Prints the card's name and power limit.  Needs a CUDA device."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SHIM = r'''
#include "%(src)s"

__constant__ float cU[2 * 16 + 2];       // R, Q, mu, 80 / mu (A = 4)
struct ConstR {
  __device__ float operator[](int k) const { return cU[k]; }
};
struct ConstQ {
  __device__ float operator[](int k) const { return cU[16 + k]; }
};

__global__ void __launch_bounds__(kMaxThreads, 4) fwd_const(
    const float* __restrict__ b, float* __restrict__ P, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float Pi[16];
  fwd_element<4, 12, 12>(ConstR(), cU[32], cU[33], b[i], Pi, 12, 12);
  store_row<4>(P + (size_t)i * 16, Pi);
}

__global__ void __launch_bounds__(kMaxThreads, 2) bwd_const(
    const float* __restrict__ b, const float* __restrict__ P,
    const float* __restrict__ g, float* __restrict__ part,
    unsigned int* __restrict__ ticket, float* __restrict__ qbar,
    float* __restrict__ bbar, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[16];
  for (int c = 0; c < 16; ++c) v[c] = 0.f;
  if (i < B) {
    float Pv[16], E[16], field[16];
    load_row<4>(P + (size_t)i * 16, Pv);
    load_row<4>(g + (size_t)i * 16, E);
    bbar[i] = bwd_element<4, 12, 12>(ConstR(), ConstQ(), cU[32], cU[33],
                                     b[i], Pv, E, field, 12, 12);
    for (int c = 0; c < 16; ++c) v[c] = field[c];
  }
  qbar_reduce<4>(v, part, ticket, qbar);
}

// P through a shared tile (pitch 5 float4 a thread), stored by the block
// as consecutive float4s
__global__ void __launch_bounds__(kMaxThreads, 4) fwd_smem(
    const float* __restrict__ Q, const float* __restrict__ b,
    float* __restrict__ P, int B) {
  __shared__ Uniform<4> u;
  __shared__ float4 tile[kMaxThreads * 5];
  load_uniform<4>(Q, u);
  __syncthreads();
  const int t = threadIdx.x, T = blockDim.x;
  const int i = blockIdx.x * T + t;
  if (i < B) {
    float R[16], Pi[16];
    for (int c = 0; c < 16; ++c) R[c] = u.R[c];
    fwd_element<4, 12, 12>(R, u.mu, u.clampv, b[i], Pi, 12, 12);
    for (int c = 0; c < 4; ++c)
      tile[t * 5 + c] = make_float4(Pi[4 * c], Pi[4 * c + 1], Pi[4 * c + 2],
                                    Pi[4 * c + 3]);
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(P) + (size_t)blockIdx.x * T * 4;
  const int n4 = 4 * min(T, B - (int)blockIdx.x * T);
  for (int j = t; j < n4; j += T) out[j] = tile[(j / 4) * 5 + j %% 4];
}

// the forward with another register budget: MINB blocks of 512 an SM
template <int MINB>
__global__ void __launch_bounds__(kMaxThreads, MINB) fwd_lb(
    const float* __restrict__ Q, const float* __restrict__ b,
    float* __restrict__ P, int B) {
  __shared__ Uniform<4> u;
  load_uniform<4>(Q, u);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float R[16], Pi[16];
  for (int c = 0; c < 16; ++c) R[c] = u.R[c];
  fwd_element<4, 12, 12>(R, u.mu, u.clampv, b[i], Pi, 12, 12);
  store_row<4>(P + (size_t)i * 16, Pi);
}

// the backward with another register budget: MINB blocks of 512 an SM
template <int MINB>
__global__ void __launch_bounds__(kMaxThreads, MINB) bwd_lb(
    const float* __restrict__ Q, const float* __restrict__ b,
    const float* __restrict__ P, const float* __restrict__ g,
    float* __restrict__ part, unsigned int* __restrict__ ticket,
    float* __restrict__ qbar, float* __restrict__ bbar, int B) {
  __shared__ Uniform<4> u;
  load_uniform<4>(Q, u);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[16];
  for (int c = 0; c < 16; ++c) v[c] = 0.f;
  if (i < B) {
    float R[16], Qr[16], Pv[16], E[16], field[16];
    for (int c = 0; c < 16; ++c) {
      R[c] = u.R[c];
      Qr[c] = u.Q[c];
    }
    load_row<4>(P + (size_t)i * 16, Pv);
    load_row<4>(g + (size_t)i * 16, E);
    bbar[i] = bwd_element<4, 12, 12>(R, Qr, u.mu, u.clampv, b[i], Pv, E,
                                     field, 12, 12);
    for (int c = 0; c < 16; ++c) v[c] = field[c];
  }
  qbar_reduce<4>(v, part, ticket, qbar);
}

extern "C" int set_uniform(const float* src, void* stream) {
  cudaMemcpyToSymbolAsync(cU, src, sizeof(cU), 0, cudaMemcpyDeviceToDevice,
                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// form 0 fwd_const, 1 bwd_const, 2 / 3 the generic instance's forward /
// backward at (12, 12), 4 fwd_smem, 5 / 6 bwd_lb<1> / <3>, 7 / 8
// fwd_lb<2> / <3>
extern "C" int run_form(int form, const float* Q, const float* b,
                        const float* P, const float* g, float* out,
                        float* part, unsigned int* ticket, float* qbar,
                        float* bbar, int B, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + threads - 1) / threads;
  switch (form) {
    case 0: fwd_const<<<blocks, threads, 0, st>>>(b, out, B); break;
    case 1:
      bwd_const<<<blocks, threads, 0, st>>>(b, P, g, part, ticket, qbar,
                                            bbar, B);
      break;
    case 2:
      expm_fwd_kernel<4, 0, 0><<<blocks, threads, 0, st>>>(Q, b, out, B,
                                                           12, 12);
      break;
    case 3:
      expm_bwd_kernel<4, 0, 0><<<blocks, threads, 0, st>>>(
          Q, b, P, g, part, ticket, qbar, bbar, B, 12, 12);
      break;
    case 4: fwd_smem<<<blocks, threads, 0, st>>>(Q, b, out, B); break;
    case 5:
      bwd_lb<1><<<blocks, threads, 0, st>>>(Q, b, P, g, part, ticket, qbar,
                                            bbar, B);
      break;
    case 6:
      bwd_lb<3><<<blocks, threads, 0, st>>>(Q, b, P, g, part, ticket, qbar,
                                            bbar, B);
      break;
    case 7: fwd_lb<2><<<blocks, threads, 0, st>>>(Q, b, out, B); break;
    case 8: fwd_lb<3><<<blocks, threads, 0, st>>>(Q, b, out, B); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class K>
int info(K kernel, int threads, int* out) {
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, threads, 0);
  return (int)cudaGetLastError();
}

// registers, local bytes, static shared bytes and resident blocks an SM
extern "C" int kernel_info(int which, int threads, int* out) {
  switch (which) {
    case 0: return info(expm_fwd_kernel<4, 12, 12>, threads, out);
    case 1: return info(expm_bwd_kernel<4, 12, 12>, threads, out);
    case 2: return info(expm_fwd_kernel<4, 0, 0>, threads, out);
    case 3: return info(expm_bwd_kernel<4, 0, 0>, threads, out);
    case 4: return info(fwd_const, threads, out);
    case 5: return info(bwd_const, threads, out);
    case 6: return info(fwd_smem, threads, out);
    case 7: return info(bwd_lb<1>, threads, out);
    case 8: return info(bwd_lb<3>, threads, out);
    case 9: return info(fwd_lb<2>, threads, out);
    case 10: return info(fwd_lb<3>, threads, out);
  }
  return (int)cudaErrorInvalidValue;
}
'''
FORM_THREADS = (64, 128, 256, 512)
INFO = ("expm_fwd_kernel<4,12,12>", "expm_bwd_kernel<4,12,12>",
        "expm_fwd_kernel<4,0,0> (generic)", "expm_bwd_kernel<4,0,0> (generic)",
        "fwd_const", "bwd_const", "fwd_smem", "bwd 128 registers",
        "bwd 42 registers", "fwd 64 registers", "fwd 42 registers")


def build_shim(ptxas):
    from phylo_tpu_torch import _ext

    out_dir = os.path.join(_ext.build_dir(), "forms")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "expm_forms.cu")
    with open(src, "w") as fh:
        fh.write(SHIM % {"src": os.path.join(_ext.CSRC, "expm_kernels.cu")})
    so = os.path.join(out_dir, "expm_forms.so")
    cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS] + (
        ["-Xptxas", "-v"] if ptxas else []) + ["-o", so, src]
    log = subprocess.run(cmd, check=True, capture_output=True, text=True)
    if ptxas:
        print(log.stdout + log.stderr)
    lib = ctypes.CDLL(so)
    lib.set_uniform.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.run_form.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.kernel_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def turns(calls):
    """{name: ms} timing each call in the order a, b, ..., b, a."""
    names = list(calls) + list(calls)[::-1]
    got = {}
    for n in names:
        got.setdefault(n, []).append(cs.time_ms(calls[n]))
    return got


def main(argv):
    if not torch.cuda.is_available():
        print("torch_expm_forms: no CUDA device visible", file=sys.stderr)
        return 1
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.models import expm_kernel as ek
    from phylo_tpu_torch.models.expm import CLAMP, uniformize

    t0 = time.time()
    _ext.build_all(["expm_kernels"], verbose="--ptxas" in argv)
    lib = build_shim("--ptxas" in argv)
    card = cs.card_line()
    cs.log(f"built in {time.time() - t0:.1f} s; card: {card}; torch "
           f"{torch.__version__}")
    dev = torch.device("cuda")
    report = {"card": card, "kernels": {}, "shapes": {}}
    buf = (ctypes.c_int * 4)()
    for which, name in enumerate(INFO):
        rows = {}
        for threads in FORM_THREADS:
            _ext.check(lib.kernel_info(which, threads, buf), name)
            regs, local, smem, blocks = list(buf)
            rows[threads] = dict(regs=regs, local_bytes=local,
                                 static_smem=smem, blocks_per_sm=blocks,
                                 warps_per_sm=blocks * threads // 32)
        report["kernels"][name] = rows
        cs.log(f"{name}: " + json.dumps(rows))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fwd = _ext.bind("expm_kernels", "launch_expm_fwd", 3, 6)
    bwd = _ext.bind("expm_kernels", "launch_expm_bwd", 8, 6)
    st = _ext.stream_ptr(dev)
    f = dict(dtype=torch.float32, device=dev)
    for label, (Q, b) in (
            ("primate 45,056", cs.expm_inputs(gen, dev)),
            ("DS1 gtr+g4 425,984", cs.expm_inputs(gen, dev, "gtr+g4")),
            ("twist rank 0 898,560", cs.expm_inputs(
                gen, dev, "gtr+g4", pairs=cs.N_DS1 * (cs.N_DS1 - 1) // 2)),
            ("twist last rank 7,680", cs.expm_inputs(gen, dev, "gtr+g4",
                                                      pairs=3))):
        B = b.shape[0]
        P = ek.expm_fwd(Q, b)
        g = torch.randn((B, 4, 4), generator=gen, **f)
        q_ref, b_ref = ek.expm_bwd(Q, b, P, g)
        out = torch.empty_like(P)
        bbar = torch.empty_like(b)
        qbar = torch.empty((4, 4), **f)
        part = torch.empty((-(-B // 64), 16), **f)
        ticket = ek._ticket(dev)

        def launch(kind, threads):
            blocks = -(-B // threads)
            if kind == "fwd":
                code = fwd(Q.data_ptr(), b.data_ptr(), out.data_ptr(), B, 4,
                           12, 12, threads, blocks, st)
            else:
                code = bwd(Q.data_ptr(), b.data_ptr(), P.data_ptr(),
                           g.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                           qbar.data_ptr(), bbar.data_ptr(), B, 4, 12, 12,
                           threads, blocks, st)
            _ext.check(code, f"K4 {kind} T={threads}")

        def form(k, threads):
            _ext.check(lib.run_form(
                k, Q.data_ptr(), b.data_ptr(), P.data_ptr(), g.data_ptr(),
                out.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                qbar.data_ptr(), bbar.data_ptr(), B, threads, st),
                f"K4 form {k}")

        entry = {"plan": ek.expm_plan(B, 4)}
        for kind in ("fwd", "bwd"):
            for T in FORM_THREADS:
                launch(kind, T)
                torch.cuda.synchronize()
                err = (cs.max_abs(out, P) if kind == "fwd" else
                       max(cs.max_rel(qbar, q_ref), cs.max_rel(bbar, b_ref)))
                cs.require(err <= 1e-5, f"{label} {kind} T={T}: err {err}")
            entry[f"{kind} block size ms"] = turns(
                {T: (lambda kind=kind, T=T: launch(kind, T))
                 for T in FORM_THREADS})
        T = {"fwd": entry["plan"][0], "bwd": ek.expm_plan(B, 4, True)[0]}
        entry["plan"] = {k: (t, -(-B // t)) for k, t in T.items()}
        mu, R = uniformize(Q)
        U = torch.cat([R.reshape(-1), Q.reshape(-1), mu.reshape(1),
                       (CLAMP / mu).reshape(1)]).contiguous()
        _ext.check(lib.set_uniform(U.data_ptr(), st), "set_uniform")
        for name, k, kind in (("R in the constant bank", 0, "fwd"),
                              ("R in the constant bank", 1, "bwd"),
                              ("generic instance", 2, "fwd"),
                              ("generic instance", 3, "bwd"),
                              ("P staged in shared memory", 4, "fwd"),
                              ("128 registers", 5, "bwd"),
                              ("42 registers", 6, "bwd"),
                              ("64 registers", 7, "fwd"),
                              ("42 registers", 8, "fwd")):
            form(k, T[kind])
            torch.cuda.synchronize()
            if kind == "fwd":
                err = cs.max_abs(out, P)
                bits = bool(torch.equal(out, P))
            else:
                err = max(cs.max_rel(qbar, q_ref), cs.max_rel(bbar, b_ref))
                bits = bool(torch.equal(qbar, q_ref)
                            and torch.equal(bbar, b_ref))
            cs.require(err <= 1e-5, f"{label} {name} {kind}: err {err}")
            entry[f"{kind} {name}"] = dict(err=err, same_bits=bits, ms=turns(
                {"launcher": lambda kind=kind: launch(kind, T[kind]),
                 name: lambda k=k, kind=kind: form(k, T[kind])}))
        report["shapes"][label] = entry
        cs.log(f"{label} (B={B}): " + json.dumps(entry))
        del P, g, out, part
        torch.cuda.empty_cache()
    cs.log("report " + json.dumps(report))
    cs.log(f"done in {time.time() - t0:.1f} s; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
