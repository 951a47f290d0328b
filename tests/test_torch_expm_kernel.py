"""Kernel K4's plain versions and launch plan, held on the CPU.

* The plain backward `_expm_bwd_plain`, which returns the pair
  (Q_bar, b_bar) the CUDA backward returns in one launch, against JAX's
  `_bwd_impl` (the Pallas kernel in interpret mode, reduced by its
  jnp.sum) and `_expm_bwd` (b_bar, zero past the clamp), in float64 with
  every fourth branch past mu * b = 80.
* `expm_plan`: every element covered once, at most 1,024 threads a block,
  and a grid of at least one block per SM of an H100 once the batch has
  132 * 64 elements.
* `_block_sum`, the kernel's order of the batch sum (per block, then the
  blocks in order), against a plain torch.sum.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import expm_kernel as jek
from phylo_tpu_torch.models import expm as texpm
from phylo_tpu_torch.models import expm_kernel as tek

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    old_tb = jek.TB
    jek.INTERPRET = True
    jek.TB = 128
    yield
    jek.INTERPRET = False
    jek.TB = old_tb


def _rate_matrix(rng, A):
    M = rng.uniform(0.1, 1.0, (A, A))
    return M - np.diag(M.sum(1))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("A,order,squarings", [(4, 4, 3), (3, 3, 2)])
def test_plain_backward_matches_pallas_interpret(interpret_mode, rng, A,
                                                 order, squarings):
    B = 128
    Q = _rate_matrix(rng, A)
    b = rng.uniform(0.05, 2.0, (B,))
    b[::4] = 500.0                       # past the mu * b <= 80 clamp
    g = rng.standard_normal((B, A, A))
    # any P serves (both sides read the same one): the plain chain's
    P = texpm.expm_chain(_t(Q), _t(b), order, squarings).numpy()
    # jitted: the interpret-mode trace runs ~2x faster than op by op
    qbar_w, bbar_w = jax.jit(jek._expm_bwd, static_argnums=(0, 1))(
        order, squarings, (jnp.asarray(Q), jnp.asarray(b), jnp.asarray(P)),
        jnp.asarray(g))                  # Q_bar from _bwd_impl's Pallas call

    qbar, bbar = tek._expm_bwd_plain(_t(Q), _t(b), _t(P), _t(g), order,
                                     squarings)
    assert qbar.shape == (A, A) and bbar.shape == (B,)
    for got, want in ((qbar, qbar_w), (bbar, bbar_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-12)
    assert float(bbar[::4].abs().max()) == 0.0
    assert float(bbar[1::4].abs().max()) > 0.0


def test_wrappers_on_cpu_run_the_plain_versions(rng):
    """expm_fwd / expm_bwd take Q itself (the kernels uniformize it): on
    CPU tensors they are the plain versions."""
    Q = _t(_rate_matrix(rng, 4))
    b = _t(rng.uniform(0.01, 3.0, (37,)))
    g = _t(rng.standard_normal((37, 4, 4)))
    P = tek.expm_fwd(Q, b, 5, 4)
    np.testing.assert_array_equal(P.numpy(),
                                  tek._expm_fwd_plain(Q, b, 5, 4).numpy())
    # the kernel's association against the JAX package's (models.expm)
    np.testing.assert_allclose(P.numpy(),
                               texpm.expm_chain(Q, b, 5, 4).numpy(),
                               rtol=0, atol=1e-14)
    got = tek.expm_bwd(Q, b, P, g, 5, 4)
    want = tek._expm_bwd_plain(Q, b, P, g, 5, 4)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [1, 31, 4099, 7680, 42240, 45056, 425984,
                               898560])
def test_expm_plan_covers_the_batch(B, backward):
    threads, blocks = tek.expm_plan(B, 4, backward)
    assert threads % 32 == 0 and 64 <= threads <= 1024
    assert threads in tek.PLAN_THREADS
    assert (blocks - 1) * threads < B <= blocks * threads
    if B >= tek.SMS * 64:
        assert blocks >= tek.SMS


def test_expm_plan_balances_the_sms():
    """The forward at every size and the backward below LARGE_B: no other
    block size gives the busiest SM fewer elements; primate's 45,056
    matrices (176 blocks of 256, 44 SMs with two) and the twist's 42,240
    and 7,680 take blocks of 64.  The backward takes BWD_LARGE_THREADS
    from LARGE_B up."""
    for B in list(range(tek.SMS * 64, tek.LARGE_B, 997)) + [425984, 898560]:
        threads, blocks = tek.expm_plan(B, 4)
        busiest = -(-blocks // tek.SMS) * threads
        for t in tek.PLAN_THREADS:
            assert busiest <= -(-(-(-B // t)) // tek.SMS) * t
        if B < tek.LARGE_B:
            assert (threads, blocks) == tek.expm_plan(B, 4, backward=True)
        else:
            assert tek.expm_plan(B, 4, True)[0] == tek.BWD_LARGE_THREADS
    for B in (7680, 42240, 45056):
        assert tek.expm_plan(B, 4)[0] == 64
    with pytest.raises(ValueError):
        tek.expm_plan(10, 9)


@pytest.mark.parametrize("B,threads", [(1, 64), (255, 64), (257, 128),
                                       (4099, 256)])
def test_block_sum_matches_torch_sum(rng, B, threads):
    field = _t(rng.standard_normal((B, 4, 4)))
    np.testing.assert_allclose(tek._block_sum(field, threads).numpy(),
                               torch.sum(field, 0).numpy(), rtol=0,
                               atol=1e-12)
