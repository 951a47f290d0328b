"""VNCSMC with a rate mixture (GTR+Gamma4: the twist enumerates 16 dense
states) and the last twist / merge kernels' plain versions, held against
the JAX package in float64.

* The twist + GTR+G4 sweep under injected decisions (test_twist.py's
  `make_twist_decisions`) at 4 taxa: per-rank fields and the ELBO to
  1e-9, and the gradients of the manual VJP (K7 wide's and K11c's plain
  versions in its twist reverse pass, K11a's for the chosen merges) and
  of plain autograd against jax.grad to 1e-8.  The JAX sweep's pair
  log-likelihood expression `_pair_ll_ref` unrolls A^2 = 256 multiply-
  adds in Python, traced four times under jax.grad (40 s to trace and
  compile on the CPU), so the JAX reference runs with it replaced by one
  einsum of the same function (9 s); `test_plain_k7_wide_matches_jax_vjp`
  holds that einsum to JAX's own `_pair_ll_ref` at A = 16.
* The plain K7 at A = 16 against jax.vjp of `_pair_ll_ref`, and the plain
  K11c (T-field) equal to it.
* At A = 4, in interpret mode: the plain K11b against
  `fused_pair_loglik` (both Pallas sites, `_pair_ll_forward` and
  `_pair_ll_forward2`), the plain K11c against `_pair_ll_bwd_pallas`
  with TWIST_BWD_V2 set, the plain K11a against `_merge_bwd_pallas`.
* A `--nested=True --model=gtr+g4` runner epoch on the CPU.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.substitution import get_model as j_get_model
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu.smc.twist import TwistConfig as JTwist
from phylo_tpu_torch import _ext
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
from phylo_tpu_torch.train.trainer import param_tensors

from test_torch_sweep import random_genome
from test_twist import make_twist_decisions

torch.set_num_threads(1)

FIELDS = ("log_weights", "log_likelihood", "elbo", "log_likelihood_R",
          "q_proposal")
SPEC, N, S, K, M = "gtr+g4", 4, 24, 4, 2


def _pair_ll_einsum(m1, m2, P_l, P_r, pi, weights):
    """JAX's `_pair_ll_ref` as einsums: the same function, 4x quicker to
    trace and compile under jax.grad at 16 states."""
    hp = jax.lax.Precision.HIGHEST
    u = jnp.einsum("kas,mkab->mkbs", m1, P_l, precision=hp)
    v = jnp.einsum("kas,mkab->mkbs", m2, P_r, precision=hp)
    site = jnp.einsum("mkbs,b->mks", u * v, pi, precision=hp)
    return jnp.sum(jnp.log(site) * weights[None, None, :], axis=-1)


@pytest.fixture(scope="module")
def case():
    """numpy inputs, the JAX twist + GTR+G4 sweep's fields and jax.grad of
    its ELBO, from one compiled value_and_grad."""
    genome = random_genome(90, N=N, S=S)
    rng = np.random.default_rng(91)
    jmodel = j_get_model(SPEC, A=4)
    tree = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0.0, 0.3, np.shape(x)), {"model": jmodel.init_params(jnp.float64),
                                 "branches": j_branches(N, dtype=jnp.float64)})
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))
    # remat only trades memory for recompute: the same values, quicker
    # to compile
    cfg = JConfig(K=K, twist=JTwist(M=M, remat=False))

    def run(p):
        res = j_sample(jax.random.PRNGKey(0), leaves, jmodel, p, cfg,
                       decisions=jax.tree.map(jnp.asarray, dec))
        return res.elbo, {f: getattr(res, f) for f in FIELDS}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jk, "_pair_ll_ref", _pair_ll_einsum)
        (_, want), want_g = jax.jit(jax.value_and_grad(run, has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    return dict(genome=genome, tree=tree, dec=dec,
                want=jax.tree.map(np.asarray, want),
                want_g=jax.tree.map(np.asarray, want_g))


def _port(case, manual_vjp=True, requires_grad=True):
    model = get_model(SPEC, A=4)
    params = params_from_numpy(case["tree"], requires_grad=requires_grad)
    res = sample_phylogenies(
        None, torch.tensor(model.expand_leaves(case["genome"])), model,
        params, SweepConfig(K=K, manual_vjp=manual_vjp,
                            twist=tw.TwistConfig(M=M)),
        decisions={k: torch.tensor(v) for k, v in case["dec"].items()})
    return res, params


def test_twist_mixture_sweep_matches_jax(case):
    got, _ = _port(case, requires_grad=False)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), case["want"][f],
                                   rtol=1e-9, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("route", ["manual", "manual_t_field", "autograd"])
def test_twist_mixture_grads_match_jax_grad(case, route, monkeypatch):
    """The manual VJP runs the plain K7 (or, with TWIST_BWD_V2, K11c) in
    its twist reverse pass and K11a for the chosen merges; autograd
    differentiates the plain sweep."""
    monkeypatch.setattr(tk, "TWIST_BWD_V2", route == "manual_t_field")
    calls = {"merge_bwd": 0}

    def counted(*a):
        calls["merge_bwd"] += 1
        return tk.merge_bwd(*a)
    monkeypatch.setattr("phylo_tpu_torch.smc.sweep_vjp.merge_bwd", counted)
    res, params = _port(case, manual_vjp=route != "autograd")
    res.elbo.backward()
    assert calls["merge_bwd"] == (0 if route == "autograd" else N - 1)
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    for path, w in jax.tree_util.tree_leaves_with_path(case["want_g"]):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


def _twist_inputs(rng, Kc, A, S_, M_):
    m1 = rng.uniform(0.05, 1.0, (Kc, A, S_))
    m2 = rng.uniform(0.05, 1.0, (Kc, A, S_))
    P_l = rng.uniform(0.05, 1.0, (M_, Kc, A, A))
    P_r = rng.uniform(0.05, 1.0, (M_, Kc, A, A))
    pi = rng.dirichlet(np.ones(A))
    w = rng.uniform(0.5, 2.0, (S_,))
    g = rng.normal(0, 1.0, (M_, Kc))
    return (m1, m2, P_l, P_r, pi, w), g


def _t(xs):
    return [torch.tensor(x) for x in xs]


def test_plain_k7_wide_matches_jax_vjp():
    """At A = 16: the plain K7 (and `pair_ll_bwd` on the CPU) against
    jax.vjp of JAX's `_pair_ll_ref`; the forward and the einsum form the
    sweep's JAX reference uses against `_pair_ll_ref`; the plain K11c,
    which the card's T-field kernel is held to, equal to the plain K7."""
    args, g = _twist_inputs(np.random.default_rng(92), 3, 16, 9, 2)
    jargs = [jnp.asarray(x) for x in args]
    want, vjp = jax.vjp(jk._pair_ll_ref, *jargs)
    want_g = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(_pair_ll_einsum(*jargs)),
                               np.asarray(want), rtol=1e-13)
    np.testing.assert_allclose(tk._pair_ll_ref(*_t(args)).numpy(),
                               np.asarray(want), rtol=1e-13)
    before = dict(_ext.LAUNCHES)
    got = tk.pair_ll_bwd(*_t(args), torch.tensor(g))
    assert dict(_ext.LAUNCHES) == before      # CPU: plain version only
    t_field = tk._pair_ll_bwd_t_ref(*_t(args), torch.tensor(g))
    for name, a, b, c in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"], got,
                             want_g, t_field):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=f"T-field {name}")


@pytest.fixture
def interpret_mode():
    jk.INTERPRET = True
    yield
    jk.INTERPRET = False


@pytest.mark.parametrize("fwd_v2", [True, False])
def test_plain_k11b_matches_pallas_interpret(interpret_mode, monkeypatch,
                                             fwd_v2):
    """K11b's plain version against `fused_pair_loglik` through both
    Pallas sites: `_pair_ll_forward2` (PHYLO_TWIST_FWD_V2, the default)
    and `_pair_ll_forward`; `fused_pair_loglik`'s gradient in the port
    equals `pair_loglik`'s."""
    monkeypatch.setattr(jk, "TWIST_FWD_V2", fwd_v2)
    args, g = _twist_inputs(np.random.default_rng(93), 6, 4, 20, 3)
    want = jk.fused_pair_loglik(*map(jnp.asarray, args))
    ins = [t.requires_grad_(True) for t in _t(args)]
    got = tk.fused_pair_loglik(*ins)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12)
    assert torch.equal(tk.pair_ll_fwd(*_t(args)), got.detach())
    got_g = torch.autograd.grad(got, ins, torch.tensor(g))
    ins2 = [t.detach().requires_grad_(True) for t in ins]
    want_g = torch.autograd.grad(tk.pair_loglik(*ins2), ins2,
                                 torch.tensor(g))
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


def test_plain_k11c_matches_pallas_interpret(interpret_mode, monkeypatch):
    """The T-field backward: `pair_ll_bwd` with TWIST_BWD_V2 (its plain
    version on the CPU) against `_pair_ll_bwd_pallas` running
    `_kernel_ll_bwd2`."""
    monkeypatch.setattr(jk, "TWIST_BWD_V2", True)
    monkeypatch.setattr(tk, "TWIST_BWD_V2", True)
    args, g = _twist_inputs(np.random.default_rng(94), 10, 4, 30, 3)
    want = jk._pair_ll_bwd_pallas(*map(jnp.asarray, args), jnp.asarray(g))
    got = tk.pair_ll_bwd(*_t(args), torch.tensor(g))
    for name, a, b in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"], got,
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_plain_k11a_matches_pallas_interpret(interpret_mode):
    """`merge_bwd` (K11a; its plain version on the CPU) against
    `_merge_bwd_pallas`, on the first 3 particles with every plane tied
    at the max (reduce-max's cotangent split among ties)."""
    rng = np.random.default_rng(95)
    Kc, A, S_ = 6, 4, 25
    m1 = rng.uniform(0.05, 1.0, (Kc, A, S_))
    m2 = rng.uniform(0.05, 1.0, (Kc, A, S_))
    P_l = rng.uniform(0.05, 1.0, (Kc, A, A))
    P_r = rng.uniform(0.05, 1.0, (Kc, A, A))
    pi = rng.dirichlet(np.ones(A))
    P_l[:3] = P_l[:3, :, :1]
    P_r[:3] = P_r[:3, :, :1]
    w = rng.uniform(0.5, 2.0, (S_,))
    cts = (rng.normal(size=(Kc, A, S_)), rng.normal(size=Kc),
           rng.normal(size=Kc))
    args = (m1, m2, P_l, P_r, pi, w) + cts
    want = jk._merge_bwd_pallas(*map(jnp.asarray, args))
    got = tk.merge_bwd(*_t(args))
    for name, a, b in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"], got,
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_runner_nested_gtr_g4_cpu(tmp_path):
    res = runner.run(["--dataset=load_strings", "--model=gtr+g4",
                      "--nested=True", "--M=2", "--n_particles=4",
                      "--num_epoch=1", "--batch_size=10", "--device=cpu",
                      f"--results_dir={tmp_path}"])
    assert np.isfinite(res.elbo)
    for t in param_tensors(res.params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert bool((t.grad != 0).any())


def test_twist_state_limit():
    """The twist kernels take up to 64 dense states; above, the card
    raises naming the ROADMAP (checked before any tensor is touched)."""
    tk.check_states(64, tk.MAX_TWIST_A, "twist")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.check_states(65, tk.MAX_TWIST_A, "twist")
