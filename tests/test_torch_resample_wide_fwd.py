"""K9f's launch plan and K5's plain inverse-CDF draw, held on the CPU.

* `wide_fwd_plan` (the wide rank forward K9f, dense and blocked): every
  chunk of sites covered by one block of its particle's cluster, a
  cluster of at most 8 blocks, shared memory within a block's 227 KB,
  threads covering every (4-plane, TS-site) tile, a grid of at least one
  block for each of the H100's 132 SMs at the main paths' shapes, every
  G <= 32 blocks of A <= 128 states accepted (in block groups where one
  does not fit) and 33 blocks or 129 states refused.
* `_categorical_plain` (K5's plain version) against a NumPy
  transcription of the same integer steps (its own Philox4x32-10,
  float32 weights, int64 prefix sums, a float64 scale, searchsorted),
  index for index; -inf particles never drawn; all -inf giving zeros;
  the multinomial law by chi-square; one stream per seed.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import resample_kernel as rk

torch.set_num_threads(1)

# (K, G, A, S) of K9f on the main paths, phase 3 and phase 2's side checks
FWD_SHAPES = [(128, 1, 61, 256), (128, 1, 61, 1086), (32, 1, 16, 256),
              (256, 4, 20, 256), (256, 4, 20, 500), (64, 4, 20, 256),
              (256, 5, 20, 256), (8, 1, 100, 70), (16, 14, 9, 100)]


# ------------------------------------------------------------ K9f's plan
@pytest.mark.parametrize("K,G,A,S", FWD_SHAPES)
@pytest.mark.parametrize("ts", [4, 8])
def test_wide_fwd_plan_covers_each_chunk_once(K, G, A, S, ts):
    sc, cluster, threads, blocks, smem = tk.wide_fwd_plan(K, G, A, S,
                                                          ts=ts)
    assert sc % ts == 0 and sc // ts >= 2
    chunks = -(-S // sc)
    assert 1 <= cluster <= min(tk.MAX_CLUSTER, chunks)
    assert cluster & (cluster - 1) == 0          # a power of two
    assert blocks == cluster * K
    # block r takes chunks r, r + cluster, ...: each chunk exactly once
    taken = sorted(c for r in range(cluster)
                   for c in range(r, chunks, cluster))
    assert taken == list(range(chunks))
    assert threads % 32 == 0 and threads % sc == 0
    assert -(-A // 4) * G * (sc // ts) <= threads <= tk.WIDE_FWD_THREADS
    assert smem == tk.wide_fwd_smem(G, A, sc, threads) <= tk.SMEM_LIMIT


@pytest.mark.parametrize("K,G,A,S", [(128, 1, 61, 256), (256, 4, 20, 256),
                                     (256, 4, 20, 500)])
def test_wide_fwd_plan_fills_the_card(K, G, A, S):
    """At least one block for each of the 132 SMs, within one wave of
    the blocks an SM holds (by shared memory and 128 registers a
    thread)."""
    sc, cluster, threads, blocks, smem = tk.wide_fwd_plan(K, G, A, S)
    assert blocks >= tk.SMS
    per_sm = min(tk.SMEM_LIMIT // smem, 65536 // (128 * threads))
    assert cluster == 1 or blocks <= tk.SMS * per_sm


def test_wide_fwd_plan_accepts_every_plane_count():
    """Every G <= 32 blocks of A <= 128 states has a launch (in block
    groups beyond one group's threads or shared memory); more blocks or
    wider ones raise."""
    for A in range(1, 129):
        for G in range(1, tk.MAX_G + 1):
            sc, cluster, threads, _, smem = tk.wide_fwd_plan(64, G, A, 256)
            assert threads <= tk.WIDE_FWD_THREADS and smem <= tk.SMEM_LIMIT
    for G, A in ((1, 129), (33, 43), (129, 1)):
        with pytest.raises(NotImplementedError):
            tk.wide_fwd_plan(64, G, A, 256)


# ------------------------------------------------------------ K5
def _np_philox(p, k0, k1):
    """Philox4x32-10 words at counters (p, 0, 0, 0) in uint64 arithmetic
    (each product of two 32-bit values fits 64 bits)."""
    m32 = np.uint64(0xFFFFFFFF)
    c0 = p.astype(np.uint64)
    c1 = np.zeros_like(c0)
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m32,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m32)
        k0 = (k0 + np.uint64(0x9E3779B9)) & m32
        k1 = (k1 + np.uint64(0xBB67AE85)) & m32
    return c0, c1, c2, c3


def _np_categorical(logits, seed):
    """K5's integer steps in NumPy."""
    K = logits.shape[0]
    E = 52 - int(math.ceil(math.log2(K))) if K > 1 else 52
    with np.errstate(invalid="ignore"):
        w = np.where(logits > -np.inf, np.exp(logits - logits.max()),
                     np.float32(0.0)).astype(np.float32)
    q = np.floor(w * np.float32(2.0 ** E)).astype(np.int64)
    C = np.cumsum(q)
    assert C[-1] <= 2 ** 52
    c0, c1, c2, c3 = _np_philox(np.arange((K + 1) // 2), seed[0], seed[1])
    s20, s12 = np.uint64(20), np.uint64(12)
    r = np.stack([(c0 << s20) | (c1 >> s12), (c2 << s20) | (c3 >> s12)],
                 axis=1).reshape(-1)[:K]
    x = np.floor((r.astype(np.float64) + 0.5) * 2.0 ** -52
                 * float(C[-1])).astype(np.int64)
    j = np.searchsorted(C, x, side="right")
    return np.where(j < K, j, 0)


@pytest.mark.parametrize("K", [1, 2, 3, 32, 33, 64, 2048])
@pytest.mark.parametrize("seed", [(12345, 678), (2 ** 32 - 1, 0)])
def test_categorical_plain_matches_numpy(K, seed):
    rng = np.random.default_rng(K)
    logits = (rng.gumbel(size=K) * 3.0).astype(np.float32)
    if K > 3:
        logits[1::5] = -np.inf
    got = rk.categorical(torch.tensor(logits),
                         torch.tensor(seed, dtype=torch.int64))
    assert got.dtype == torch.int32 and got.shape == (K,)
    np.testing.assert_array_equal(got.numpy(),
                                  _np_categorical(logits, seed))


def test_categorical_never_draws_minus_inf():
    K = 256
    logits = torch.zeros(K)
    logits[::3] = -math.inf
    logits[1] = -25.0              # below the max, above E ln 2 = 30 nats
    gen = torch.Generator().manual_seed(1)
    drawn = torch.cat([rk.categorical(logits, rk.draw_seed(gen, "cpu"))
                       for _ in range(20)]).long()
    assert not torch.any(drawn % 3 == 0)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < K


def test_categorical_all_minus_inf_gives_zeros():
    for K in (1, 5, 64):
        idx = rk.categorical(torch.full((K,), -math.inf),
                             torch.tensor([7, 9], dtype=torch.int64))
        assert torch.equal(idx, torch.zeros(K, dtype=torch.int32))


def test_categorical_chi_square_with_dead_particles():
    Kc, rounds = 64, 200
    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.normal(size=Kc) * 1.5, dtype=torch.float32)
    logits[7::9] = -math.inf
    p = torch.softmax(logits.double(), 0).numpy()
    gen = torch.Generator().manual_seed(2)
    counts = np.zeros(Kc)
    for _ in range(rounds):
        counts += np.bincount(rk.categorical(logits, rk.draw_seed(
            gen, "cpu")).numpy(), minlength=Kc)
    live = p > 0
    assert counts[~live].sum() == 0
    n = rounds * Kc
    chi2 = float(((counts[live] - n * p[live]) ** 2 / (n * p[live])).sum())
    dof = int(live.sum()) - 1
    z = (chi2 - dof) / math.sqrt(2 * dof)
    assert abs(z) < 4.0, z


def test_categorical_one_stream_per_seed():
    logits = torch.tensor(np.random.default_rng(0).normal(size=300),
                          dtype=torch.float32)
    a = rk.categorical(logits, torch.tensor([3, 4], dtype=torch.int64))
    b = rk.categorical(logits, torch.tensor([3, 4], dtype=torch.int64))
    c = rk.categorical(logits, torch.tensor([3, 5], dtype=torch.int64))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
