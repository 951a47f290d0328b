"""Kernel K5: multinomial resampling by Gumbel-max over a counter-based
random field (port of phylo_tpu/smc/resample_kernel.py).

K draws from softmax(logits): draw i takes argmax_j logits_j + g_ij with
g = -log(-log(u)), u = (n + 0.5) / 2^23 from the top 23 bits n of a
32-bit word, ties to the lowest index.  The words come from Philox4x32-10
(Salmon et al., SC'11) keyed by a (2,) int64 seed: the word for (i, j) is
word j % 4 of Philox(counter = (j // 4, i, 0, 0), key = (seed0, seed1)).

The seed is drawn on the device from the run's torch.Generator
(`draw_seed`), so no rank waits on the host.  The stream differs from the
TPU's hardware PRNG and from torch.multinomial: the draw is held to the
multinomial distribution, not to a stream.

CUDA tensors launch csrc/resample_kernels.cu, which synthesizes the field
in registers and never writes it; CPU tensors run `_categorical_plain`,
the same Philox words and the same float32 arithmetic in torch.  Indices
carry no gradient (the sweep treats them as constants).
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


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


def philox_uniforms(seed, rows, cols):
    """The kernel's (rows, cols) float32 uniform field for `seed`."""
    dev = seed.device
    n4 = -(-cols // 4)
    i = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    j4 = torch.arange(n4, dtype=torch.int64, device=dev)[None, :]
    c0 = j4.expand(rows, n4)
    c1 = i.expand(rows, n4)
    zero = torch.zeros_like(c0)
    k0 = seed[0] & _MASK
    k1 = seed[1] & _MASK
    words = torch.stack(philox4x32(c0, c1, zero, zero, k0, k1), dim=-1)
    bits = words.reshape(rows, 4 * n4)[:, :cols]
    n = (bits >> 9).to(torch.float32)
    return (n + 0.5) * (1.0 / (1 << 23))


def gumbel_argmax(logits, u):
    """argmax_j logits_j - log(-log(u_ij)) per row, ties to the lowest
    index (float32)."""
    K = logits.shape[0]
    scores = logits[None, :] - torch.log(-torch.log(u))
    m = torch.max(scores, dim=1, keepdim=True).values
    lanes = torch.arange(K, device=logits.device)
    return torch.min(torch.where(scores >= m, lanes, K), dim=1).values


def _categorical_plain(logits, seed):
    K = logits.shape[0]
    u = philox_uniforms(seed, K, K)
    return gumbel_argmax(logits.to(torch.float32), u).to(torch.int32)


def categorical(logits, seed):
    """K iid draws from softmax(logits): logits (K,) float32 (-inf
    allowed), seed (2,) int64.  Returns (K,) int32 in [0, K)."""
    if not logits.is_cuda:
        return _categorical_plain(logits, seed)
    K = logits.shape[0]
    _ext.require(logits, "logits", torch.float32, ndim=1)
    _ext.require(seed, "seed", torch.int64, shape=(2,))
    out = torch.empty((K,), dtype=torch.int32, device=logits.device)
    if K:
        fn = _ext.bind("resample_kernels", "launch_categorical", 3, 1)
        _ext.LAUNCHES["categorical"] += 1
        _ext.check(fn(logits.data_ptr(), seed.data_ptr(), out.data_ptr(),
                      K, _ext.stream_ptr(logits.device)), "categorical")
    return out
