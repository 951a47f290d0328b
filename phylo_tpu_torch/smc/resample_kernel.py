"""Kernel K5: multinomial resampling by inverse CDF in exact integer
arithmetic (port of phylo_tpu/smc/resample_kernel.py::categorical_pallas).

K iid draws from softmax(logits), logits (K,) float32 (-inf allowed):

    lmax = max_j logits_j;  w_j = exp(l_j - lmax) in float32 (0 at -inf)
    q_j = floor(w_j 2^E) as int64, E = 52 - ceil(log2 K)   (`cdf_bits`)
    C = cumsum(q) (exact), Q = C[-1] <= 2^52
    x_i = floor(((r_i + 0.5) / 2^52) Q) in float64,  draw_i = the first j
    with C_j > x_i (searchsorted right), or 0 when every logit is -inf

with r_i the top 52 bits of words (2h, 2h + 1), h = i % 2, of
Philox4x32-10 (Salmon et al., SC'11) at counter (i // 2, 0, 0, 0) and key
(seed0, seed1) (low 32 bits of a (2,) int64 seed).  The law: j is drawn
with probability q_j / Q (to 2^-52), within 2^-E / w_j relative of
softmax(logits); a particle more than E ln 2 nats below the max (28 at
K = 2048) is never drawn (the former float32 Gumbel-max form could never
draw one about 19 nats below).

The seed is drawn on the device from the run's torch.Generator
(`draw_seed`), so no rank waits on the host.  The stream differs from the
TPU's hardware PRNG and from torch.multinomial: the draw is held to the
multinomial distribution, not to a stream.

CUDA tensors launch csrc/resample_kernels.cu (one block, one launch);
CPU tensors run `_categorical_plain`, the same integer steps in torch ops
(int64 cumsum, a float64 multiply, searchsorted), so on the card the two
agree draw for draw.  Indices carry no gradient (the sweep treats them
as constants).
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
CDF_SMEM_MAX = 28672    # particles whose CDF fits a block's shared memory


def draw_seed(generator, device):
    """A (2,) int64 Philox key in [0, 2^32), drawn on `device`."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         dtype=torch.int64, device=device)


def _mulhilo(m, b):
    """(hi, lo) 32-bit halves of m * b for a 32-bit constant m and an
    int64 tensor b < 2^32, in int64 arithmetic without overflow."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds=10):
    """Philox4x32-`rounds` on int64 tensors holding uint32 values."""
    for i in range(rounds):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if i + 1 < rounds:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def cdf_bits(K):
    """E = 52 - ceil(log2 K): the bits of each q_j, so that Q < 2^53."""
    return 52 - (K - 1).bit_length()


def draw_bits(seed, K):
    """(K,) int64: draw i's 52 random bits, the top 32 of Philox word 2h
    above the top 20 of word 2h + 1 at counter (i // 2, 0, 0, 0)."""
    p = torch.arange(-(-K // 2), dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(p)
    c0, c1, c2, c3 = philox4x32(p, zero, zero, zero, seed[0] & _MASK,
                                seed[1] & _MASK)
    r = torch.stack([(c0 << 20) | (c1 >> 12), (c2 << 20) | (c3 >> 12)],
                    dim=1)
    return r.reshape(-1)[:K]


def _categorical_plain(logits, seed):
    K = logits.shape[0]
    l = logits.to(torch.float32)
    w = torch.where(l > -torch.inf, torch.exp(l - torch.max(l)), 0.0)
    q = torch.floor(w * float(2 ** cdf_bits(K))).to(torch.int64)
    C = torch.cumsum(q, 0)
    u = (draw_bits(seed, K).to(torch.float64) + 0.5) * 2.0 ** -52
    x = torch.floor(u * C[-1].to(torch.float64)).to(torch.int64)
    j = torch.searchsorted(C, x, right=True)
    return torch.where(j < K, j, 0).to(torch.int32)


def categorical(logits, seed):
    """K iid draws from softmax(logits): logits (K,) float32 (-inf
    allowed), seed (2,) int64.  Returns (K,) int32 in [0, K)."""
    if not logits.is_cuda:
        return _categorical_plain(logits, seed)
    K = logits.shape[0]
    _ext.require(logits, "logits", torch.float32, ndim=1)
    _ext.require(seed, "seed", torch.int64, shape=(2,))
    dev = logits.device
    out = torch.empty((K,), dtype=torch.int32, device=dev)
    if K:
        # C lives in shared memory up to CDF_SMEM_MAX particles
        scratch = (torch.empty((K,), dtype=torch.int64, device=dev)
                   if K > CDF_SMEM_MAX else None)
        fn = _ext.bind("resample_kernels", "launch_categorical", 4, 2)
        _ext.LAUNCHES["categorical"] += 1
        _ext.check(fn(logits.data_ptr(), seed.data_ptr(), out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), K,
                      cdf_bits(K), _ext.stream_ptr(dev)), "categorical")
    return out
