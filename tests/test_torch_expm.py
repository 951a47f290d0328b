"""Transition matrices of the port against the JAX package: the plain
delta-form chain against phylo_tpu's jnp chain (float64, forward and
autograd), and kernel K4's autograd.Function (its plain forward and
Frechet-adjoint backward, as the CPU runs them) against the JAX Pallas
kernel run in interpret mode.  Both run the same polynomial scheme, so
parity holds at any (order, squarings); the interpret-mode cases use
small ones to keep the unrolled Pallas trace fast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import expm as jexpm
from phylo_tpu.models import expm_kernel as jexpm_kernel
from phylo_tpu_torch.models import expm as texpm
from phylo_tpu_torch.models.expm_kernel import expm_ctmc_kernel

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    old_tb = jexpm_kernel.TB
    jexpm_kernel.INTERPRET = True
    jexpm_kernel.TB = 128
    yield
    jexpm_kernel.INTERPRET = False
    jexpm_kernel.TB = old_tb


def _rate_matrix(rng, A):
    M = rng.uniform(0.1, 1.0, (A, A))
    return M - np.diag(M.sum(1))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


@pytest.mark.parametrize("A", [4, 7])
def test_plain_chain_matches_jax_chain(rng, A):
    Q = _rate_matrix(rng, A)
    b = rng.uniform(0.01, 3.0, (3, 5))
    b[0, 0] = 200.0                      # past the mu * b <= 80 clamp
    g = rng.standard_normal((3, 5, A, A))

    want = jexpm.expm_ctmc(jnp.asarray(Q), jnp.asarray(b))
    dq_w, db_w = jax.grad(lambda q, bb: jnp.sum(
        jnp.asarray(g) * jexpm.expm_ctmc(q, bb)), (0, 1))(
        jnp.asarray(Q), jnp.asarray(b))

    Qt, bt = _t(Q, True), _t(b, True)
    got = texpm.expm_ctmc(Qt, bt)
    torch.sum(_t(g) * got).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Qt.grad.numpy(), np.asarray(dq_w),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_w),
                               rtol=1e-12, atol=1e-12)


def test_jc69_closed_form_matches_jax(rng):
    b = rng.uniform(0.0, 2.0, (7,))
    np.testing.assert_allclose(
        texpm.jc69_transition(_t(b), 4).numpy(),
        np.asarray(jexpm.jc69_transition(jnp.asarray(b), 4)), atol=1e-15)


def test_kernel_forward_matches_pallas_interpret(interpret_mode, rng):
    Q = _rate_matrix(rng, 4)
    b = rng.uniform(0.01, 3.0, (128,))
    b[::8] = 500.0
    want = jexpm_kernel.expm_ctmc_pallas(jnp.asarray(Q), jnp.asarray(b),
                                         4, 3)
    got = expm_ctmc_kernel(_t(Q), _t(b), 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_kernel_gradients_match_pallas_interpret(interpret_mode, rng):
    """Frechet-adjoint backward, including the clamp region where the
    Q_bar term through b_eff is dropped and b gets a zero cotangent."""
    A, order, sq = 4, 3, 2
    Q = _rate_matrix(rng, A)
    b = rng.uniform(0.05, 2.0, (128,))
    b[::4] = 500.0
    g = rng.standard_normal((128, A, A))

    dq_w, db_w = jax.grad(lambda q, bb: jnp.sum(
        jnp.asarray(g) * jexpm_kernel.expm_ctmc_pallas(q, bb, order, sq)),
        (0, 1))(jnp.asarray(Q), jnp.asarray(b))
    Qt, bt = _t(Q, True), _t(b, True)
    torch.sum(_t(g) * expm_ctmc_kernel(Qt, bt, order, sq)).backward()
    np.testing.assert_allclose(Qt.grad.numpy(), np.asarray(dq_w),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_w),
                               rtol=1e-9, atol=1e-12)
    assert float(bt.grad[::4].abs().max()) == 0.0
    assert float(bt.grad[1::4].abs().max()) > 0.0


def test_kernel_gradients_match_chain_autograd(rng):
    """Away from the clamp the Frechet adjoint equals autograd through
    the chain (the block chain is the chain's forward-mode derivative)."""
    A = 4
    Q = _rate_matrix(rng, A)
    b = rng.uniform(0.05, 2.0, (2, 9))
    g = rng.standard_normal((2, 9, A, A))
    grads = []
    for fn in (expm_ctmc_kernel, texpm.expm_chain):
        Qt, bt = _t(Q, True), _t(b, True)
        torch.sum(_t(g) * fn(Qt, bt)).backward()
        grads.append((Qt.grad, bt.grad))
    for a, w in zip(*grads):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-12)
