"""The twist over rate mixtures wider than 64 planes (protein+Gamma4: 4
blocks of 20 states), held in float64 on the CPU.

* The plain blocked forward (K11b's plain version), its VJP (K7 wide's)
  and the blocked T-field VJP (K11c's, `_pair_ll_bwd_t_ref` on P of rank
  5) at (G, A_b) = (3, 20), (4, 20), (8, 20) and (4, 61) against the
  dense forms on `blockdiag_dense` inputs to 1e-13 of each entry or of
  the array's largest (dP against the dense dP's diagonal blocks).  The
  dense forward and VJP are an einsum of `_pair_ll_ref` and its autograd
  (the unrolled form would trace 2 A^2 multiply-adds at A = 244), held
  to JAX's `_pair_ll_ref` at A = 12.
* VNCSMC protein+Gamma4 (`GammaSites(ReferenceQ(A=20), G=4)`, 4 taxa)
  against the JAX sweep under injected decisions: per-rank fields and
  the ELBO to 1e-9, manual-VJP gradients against jax.grad to 1e-8, under
  the default backward (K7 wide's plain version) and under
  PHYLO_TWIST_BWD_V2 (K11c's).  The JAX sweep enumerates the dense 80
  states; it runs with `_pair_ll_ref` replaced by an einsum of the same
  function, and with its dense rank merge (`blocked_merge=False`).
* `--nested=True --gamma_categories=4` through the runner on a small
  protein FASTA: a finite ELBO and non-zero gradients.
* The card's route without a tensor (`smc.sweep.card_refusals`): the
  twist takes every rate mixture of up to 32 blocks of 64 states
  blocked, refuses a dense model above 64 states, and the rank kernels
  take protein+Gamma8 and GY94+Gamma4 (block groups) but refuse 33
  blocks or a block of more than 128 states.
* The launch plans over block groups for every G <= 32, A_b <= 64 and
  S in {1, 31, 70, 256, 500, 1949}: shared memory within a block, threads
  within bounds, whole blocks a group, and the DS1 4 x 4 plans as
  before.
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
from phylo_tpu_torch.dataio.alphabets import PROTEIN_ALPHABET
from phylo_tpu_torch.models.substitution import GammaSites, get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import (
    SweepConfig,
    card_refusals,
    sample_phylogenies,
)
from phylo_tpu_torch.train.trainer import param_tensors

from test_twist import make_twist_decisions

torch.set_num_threads(1)

NAMES = ("dm1", "dm2", "dP_l", "dP_r", "dpi", "dw")
FIELDS = ("log_weights", "log_likelihood", "elbo", "log_likelihood_R",
          "q_proposal")
SHAPES = [(3, 20), (4, 20), (8, 20), (4, 61)]
N, S, K, M = 4, 24, 4, 2


def _inputs(seed, G, Ab, Kc=2, S_=5, M_=2):
    rng = np.random.default_rng(seed)
    A = G * Ab
    args = (rng.uniform(0.05, 1.0, (Kc, A, S_)),
            rng.uniform(0.05, 1.0, (Kc, A, S_)),
            rng.uniform(0.05, 1.0, (M_, Kc, G, Ab, Ab)),
            rng.uniform(0.05, 1.0, (M_, Kc, G, Ab, Ab)),
            rng.dirichlet(np.ones(A)), rng.uniform(0.5, 2.0, (S_,)))
    return (tuple(torch.tensor(x) for x in args),
            torch.tensor(rng.normal(0.0, 1.0, (M_, Kc))))


def _dense(args):
    return args[:2] + tuple(tk.blockdiag_dense(P) for P in args[2:4]) \
        + args[4:]


def _diag_blocks(P, G, Ab):
    return torch.stack([P[..., j * Ab:(j + 1) * Ab, j * Ab:(j + 1) * Ab]
                        for j in range(G)], dim=-3)


def _close(got, want, name, rtol=1e-13):
    """Within rtol of each entry, or of the array's largest entry: the
    cotangents are sums of terms of both signs (g is random), so an
    entry near 0 carries its terms' rounding."""
    w = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=rtol,
                               atol=rtol * np.abs(w).max(), err_msg=name)


def _ll_einsum(m1, m2, P_l, P_r, pi, weights):
    """`_pair_ll_ref` on dense P as einsums (torch)."""
    u = torch.einsum("kas,mkab->mkbs", m1, P_l)
    v = torch.einsum("kas,mkab->mkbs", m2, P_r)
    site = torch.einsum("mkbs,b->mks", u * v, pi)
    return torch.sum(torch.log(site) * weights, dim=-1)


def _vjp_einsum(args, g):
    ins = [t.detach().requires_grad_(True) for t in args]
    return torch.autograd.grad(_ll_einsum(*ins), ins, g)


def _jax_ll_einsum(m1, m2, P_l, P_r, pi, weights):
    """JAX's `_pair_ll_ref` as einsums: the same function, traced in a
    few ops at 80 states."""
    hp = jax.lax.Precision.HIGHEST
    u = jnp.einsum("kas,mkab->mkbs", m1, P_l, precision=hp)
    v = jnp.einsum("kas,mkab->mkbs", m2, P_r, precision=hp)
    site = jnp.einsum("mkbs,b->mks", u * v, pi, precision=hp)
    return jnp.sum(jnp.log(site) * weights[None, None, :], axis=-1)


def test_dense_einsum_matches_jax():
    """The dense einsum forms (torch and JAX) against JAX's unrolled
    `_pair_ll_ref`, and the torch VJP against jax.vjp, at A = 12."""
    rng = np.random.default_rng(200)
    A = 12
    args = (rng.uniform(0.05, 1.0, (3, A, 7)), rng.uniform(0.05, 1.0,
                                                           (3, A, 7)),
            rng.uniform(0.05, 1.0, (2, 3, A, A)),
            rng.uniform(0.05, 1.0, (2, 3, A, A)),
            rng.dirichlet(np.ones(A)), rng.uniform(0.5, 2.0, 7))
    g = rng.normal(size=(2, 3))
    want, vjp = jax.vjp(jk._pair_ll_ref, *map(jnp.asarray, args))
    np.testing.assert_allclose(
        np.asarray(_jax_ll_einsum(*map(jnp.asarray, args))),
        np.asarray(want), rtol=1e-13)
    t = tuple(torch.tensor(x) for x in args)
    np.testing.assert_allclose(_ll_einsum(*t).numpy(), np.asarray(want),
                               rtol=1e-13)
    for name, a, b in zip(NAMES, _vjp_einsum(t, torch.tensor(g)),
                          vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-300, err_msg=name)


@pytest.mark.parametrize("G,Ab", SHAPES)
def test_plain_blocked_fwd_equals_dense(G, Ab):
    """K11b's plain version on G blocks of A_b against the dense einsum
    on the block-diagonal form; the CPU wrapper runs it and launches
    nothing."""
    args, _ = _inputs(210 + G + Ab, G, Ab)
    want = _ll_einsum(*_dense(args))
    before = dict(_ext.LAUNCHES)
    got = tk.pair_ll_fwd(*args)
    assert dict(_ext.LAUNCHES) == before
    _close(got, want, "ll")


@pytest.mark.parametrize("t_field", [False, True])
@pytest.mark.parametrize("G,Ab", SHAPES)
def test_plain_blocked_vjp_equals_dense(G, Ab, t_field, monkeypatch):
    """`pair_ll_bwd` on the CPU on blocked P (K7 wide's plain version, or
    under TWIST_BWD_V2 the blocked T-field one) against the dense VJP
    (autograd of the einsum) and the dense T-field form on the
    block-diagonal transitions: dm1, dm2, dpi, dw, and dP (in P's blocked
    shape) against the dense dP's diagonal blocks."""
    monkeypatch.setattr(tk, "TWIST_BWD_V2", t_field)
    args, g = _inputs(230 + G + Ab, G, Ab)
    before = dict(_ext.LAUNCHES)
    got = tk.pair_ll_bwd(*args, g)
    assert dict(_ext.LAUNCHES) == before
    assert got[2].shape == args[2].shape and got[3].shape == args[3].shape
    dense = _dense(args)
    wants = [_vjp_einsum(dense, g)]
    if t_field:
        wants.append(tk._pair_ll_bwd_t_ref(*dense, g))
    for want in wants:
        for name, a, b in zip(NAMES, got, want):
            if name.startswith("dP"):
                b = _diag_blocks(b, G, Ab)
            _close(a, b, name)


def test_blocked_t_field_equals_blocked_vjp():
    """The blocked T-field plain version equals the blocked plain VJP
    (autograd of the unrolled `_pair_ll_ref`) at 4 blocks of 20."""
    args, g = _inputs(250, 4, 20)
    got = tk._pair_ll_bwd_t_ref(*args, g)
    want = tk._pair_ll_bwd_plain(*args, g)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, name, rtol=1e-12)


# ----------------------------------------------------------- the sweep
def _protein_genome(seed):
    rng = np.random.default_rng(seed)
    g = np.eye(20)[rng.integers(0, 20, (N, S))]
    g[0, :2] = 1.0                                 # missing residues
    return g


@pytest.fixture(scope="module")
def case():
    """numpy inputs, the JAX twist + protein+G4 sweep's fields and
    jax.grad of its ELBO, from one compiled value_and_grad."""
    genome = _protein_genome(260)
    rng = np.random.default_rng(261)
    jmodel = j_get_model("reference+g4", A=20)
    tree = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0.0, 0.3, np.shape(x)), {"model": jmodel.init_params(jnp.float64),
                                 "branches": j_branches(N, dtype=jnp.float64)})
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))
    cfg = JConfig(K=K, twist=JTwist(M=M, remat=False), blocked_merge=False)

    def run(p):
        res = j_sample(jax.random.PRNGKey(0), leaves, jmodel, p, cfg,
                       decisions=jax.tree.map(jnp.asarray, dec))
        return res.elbo, {f: getattr(res, f) for f in FIELDS}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jk, "_pair_ll_ref", _jax_ll_einsum)
        (_, want), want_g = jax.jit(jax.value_and_grad(run, has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    return dict(genome=genome, tree=tree, dec=dec,
                want=jax.tree.map(np.asarray, want),
                want_g=jax.tree.map(np.asarray, want_g))


def _port(case, requires_grad=True):
    model = GammaSites(get_model("reference", A=20), G=4)
    assert tk.twist_blocks(model) == (4, 20)
    params = params_from_numpy(case["tree"], requires_grad=requires_grad)
    res = sample_phylogenies(
        None, torch.tensor(model.expand_leaves(case["genome"])), model,
        params, SweepConfig(K=K, twist=tw.TwistConfig(M=M)),
        decisions={k: torch.tensor(v) for k, v in case["dec"].items()})
    return res, params


@pytest.mark.parametrize("bwd_v2", [False, True])
def test_twist_protein_g4_matches_jax(case, bwd_v2, monkeypatch):
    """Per-rank fields and the ELBO to 1e-9, and the manual VJP's
    gradients (the twist's reverse pass through the blocked plain K7 wide,
    or K11c under TWIST_BWD_V2) against jax.grad to 1e-8."""
    monkeypatch.setattr(tk, "TWIST_BWD_V2", bwd_v2)
    calls = {"plain": 0, "t_field": 0}
    for name, key in (("_pair_ll_bwd_plain", "plain"),
                      ("_pair_ll_bwd_t_ref", "t_field")):
        def counted(*a, _fn=getattr(tk, name), _key=key):
            assert a[2].ndim == 5              # blocked P
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(tk, name, counted)
    res, params = _port(case)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(res, f).detach().numpy(),
                                   case["want"][f], rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    res.elbo.backward()
    assert calls["t_field" if bwd_v2 else "plain"] > 0
    assert calls["plain" if bwd_v2 else "t_field"] == 0
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


def test_runner_nested_protein_g4_cpu(tmp_path):
    rng = np.random.default_rng(270)
    fasta = tmp_path / "prot.fa"
    seqs = ["".join(rng.choice(list(PROTEIN_ALPHABET), 10)) for _ in range(4)]
    fasta.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs)))
    res = runner.run([f"--dataset={fasta}", "--gamma_categories=4",
                      "--nested=True", "--M=2", "--n_particles=3",
                      "--num_epoch=1", "--batch_size=5", "--no_artifacts",
                      "--device=cpu"])
    assert np.isfinite(res.elbo)
    for t in param_tensors(res.params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert bool((t.grad != 0).any())


# ----------------------------------------------------------- the route
def _twist_config():
    return SweepConfig(K=4, twist=tw.TwistConfig(M=2))


@pytest.mark.parametrize("spec,planes", [("reference+g4", 80),
                                         ("reference+g3", 60),
                                         ("gtr+g4", 16), ("gy94", 61)])
def test_card_takes_the_twist(spec, planes):
    """No refusal for the twist over protein+G4 (80 planes), +G3, DS1's
    GTR+G4 and dense codons; a mixture's blocks take the blocked route."""
    model = get_model(spec, A=4 if spec == "gtr+g4" else 20 if "ref" in spec
                      else 61)
    card_refusals(_twist_config(), model, planes)
    blocks = getattr(model, "blocks", None)
    assert tk.twist_route(model, planes) == blocks


def test_card_takes_dat_f_g4(tmp_path):
    path = tmp_path / "prot.dat"
    rng = np.random.default_rng(280)
    rows = [" ".join(f"{x:.9f}" for x in rng.lognormal(0.0, 1.0, i))
            for i in range(1, 20)]
    f = rng.random(20) + 0.5
    path.write_text("\n".join(rows + ["", " ".join(
        f"{x:.12f}" for x in f / f.sum())]))
    model = get_model(f"{path}+f+g4", A=20)
    card_refusals(_twist_config(), model, 80)
    assert tk.twist_route(model, 80) == (4, 20)


def test_card_refusals():
    """A dense model above 64 states raises naming the ROADMAP before any
    tensor; the rank kernels take protein+G8 (160 planes) and GY94+G4
    (244) with or without the twist (K9 blocked in block groups), and the
    twist takes them too (its kernels' limit is per block); 33 blocks, or
    a block of more than 128 states, raise.  rescale=False is taken, on
    the plain merge."""

    class Dense:
        blocks = None

    class Mixture:
        def __init__(self, G, A):
            self.blocks = (G, A)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        card_refusals(_twist_config(), Dense(), 65)
    card_refusals(_twist_config(), Dense(), 64)
    card_refusals(SweepConfig(K=4), Dense(), 65)    # no twist: not its check
    for spec, A in (("reference+g8", 20), ("gy94+g4", 61)):
        model = get_model(spec, A=A)
        assert tk.twist_route(model, model.blocks[0] * A) == model.blocks
        for cfg in (_twist_config(), SweepConfig(K=4)):
            card_refusals(cfg, model, model.blocks[0] * A)
    for G, A in ((33, 20), (4, 129)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            card_refusals(SweepConfig(K=4), Mixture(G, A), G * A)
    # rescale=False (once refused) takes the plain merge, K1 and K8 off
    card_refusals(SweepConfig(K=4, rescale=False), Dense(), 4)
    import phylo_tpu_torch.smc.sweep as ts

    def no_kernel(*args, **kw):
        raise AssertionError("rescale=False reached a rescaling kernel")

    saved = ts.fused_rank_update, ts.fused_merge_loglik
    ts.fused_rank_update = ts.fused_merge_loglik = no_kernel
    try:
        model = get_model("jc69", A=4)
        with torch.no_grad():
            res = ts.sample_phylogenies(
                torch.Generator().manual_seed(0),
                torch.tensor(np.eye(4)[np.arange(24).reshape(4, 6) % 4]),
                model, {"model": model.init_params(torch.float64),
                        "branches": {"log_rates_l": torch.full((3,), 2.3),
                                     "log_rates_r": torch.full((3,), 2.3)}},
                SweepConfig(K=4, rescale=False))
    finally:
        ts.fused_rank_update, ts.fused_merge_loglik = saved
    assert torch.isfinite(res.elbo)


def test_twist_blocks_rule_wide():
    """`twist_blocks`: (G, A_b) for 2 <= G <= 32 blocks of A_b <= 64
    states under either backward; None above, and for G = 1."""
    class Mix:
        def __init__(self, G, Ab):
            self.blocks = (G, Ab)
    for bwd_v2 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tk, "TWIST_BWD_V2", bwd_v2)
            for G, Ab in ((2, 64), (4, 20), (4, 61), (8, 20), (32, 64),
                          (17, 4)):
                assert tk.twist_blocks(Mix(G, Ab)) == (G, Ab)
            for G, Ab in ((1, 20), (33, 4), (4, 65)):
                assert tk.twist_blocks(Mix(G, Ab)) is None


# ----------------------------------------------------------- the plans
@pytest.mark.parametrize("G", range(1, 33))
def test_group_plans(G):
    """For every A_b <= 64 (dense: G = 1) and S in {1, 31, 70, 256, 500,
    1949} at M = 10: K11b's groups hold whole blocks, all G in at most 64
    padded planes, else 32 (two sites a thread) or one block of 64; its
    tiles cover S with at most 256 threads and fit the shared memory with
    the M site sums a thread carries; K7 wide's and K11c's groups hold
    all G blocks while their chunk holds 128 sites (or all S), else one
    block; the chunk is 32-256 sites, the (4 x 4) tiles fit the threads
    and the layout the shared memory.  The one-group plans are the
    former ones."""
    Mt = 10
    for Ab in range(1, 65):
        AB, NG, groups = tk.twist_fwd_group(G, Ab)
        assert AB >= max(Ab, 4) and AB * NG <= tk.TWIST_FWD_TILE
        assert NG * groups >= G and NG * (groups - 1) < G
        if groups > 1:
            assert AB * NG == tk.TWIST_FWD_GROUP or (AB, NG) == (64, 1)
        else:
            assert AB * NG <= tk.TWIST_FWD_TILE
        NPG = -(-Ab // 4)
        for S_ in (1, 31, 70, 256, 500, 1949):
            spt, nthr, tiles = tk.twist_fwd_plan(G, Ab, S_, Mt)
            assert 32 <= nthr <= tk.FWD_MAX_THREADS and nthr % 32 == 0
            assert spt * nthr * tiles >= S_ > spt * nthr * (tiles - 1)
            assert tk.twist_fwd_smem(G, Ab, Mt, nthr, spt) <= tk.SMEM_LIMIT
            for t_field in (False, True):
                gb = tk.twist_bwd_group(G, Ab, S_, t_field, Mt)
                assert 1 <= gb <= G
                sc, threads, smem = tk.twist_bwd_plan(G, Ab, S_, t_field,
                                                      Mt, gb)
                assert 32 <= sc <= 256 and sc % 32 == 0, (G, Ab, S_, sc)
                assert smem <= tk.SMEM_LIMIT, (G, Ab, S_, smem)
                assert gb * NPG * sc // 4 <= threads <= tk.BWD_MAX_THREADS
                assert threads % 32 == 0
                assert smem == tk.twist_bwd_smem(G, Ab, sc, t_field, gb, Mt)
                if gb < G:       # one group's chunk would be too short
                    assert gb == 1
                    assert tk._bwd_sc(G, Ab, S_, t_field, G, Mt) < min(
                        tk.BWD_ONE_PASS_SC, -(-S_ // 32) * 32)
    if G == 4:
        assert tk.twist_bwd_plan(4, 4, 256)[:2] == (256, 256)
        assert tk.twist_fwd_plan(4, 4, 256) == (2, 128, 1)
        assert tk.twist_fwd_plan(4, 4, 256, Mt) == (2, 128, 1)
        # protein+G4: K11b in 4 groups of one block of 32 padded states
        # (2 sites a thread); K7 wide a block a group, one chunk of 256
        # sites (one group would take 3 chunks of 96)
        assert tk.twist_fwd_group(4, 20) == (32, 1, 4)
        assert tk.twist_fwd_plan(4, 20, 256, Mt) == (2, 128, 1)
        assert tk.twist_bwd_group(4, 20, 256, M=Mt) == 1
        assert tk.twist_bwd_plan(4, 20, 256, M=Mt) == (256, 320, 111920)
        assert tk.twist_bwd_plan(4, 20, 256, M=Mt, gb=4) == (96, 480,
                                                              187920)
        # under two blocks an SM (the last ranks' 96 and 32 rows) the
        # one-pass layout; from 264 rows a block a group
        assert tk.twist_bwd_group(4, 20, 256, M=Mt, KC=96) == 4
        assert tk.twist_bwd_group(4, 20, 256, M=Mt, KC=263) == 4
        assert tk.twist_bwd_group(4, 20, 256, M=Mt, KC=264) == 1
        # GY94+G4: a block a group in both
        assert tk.twist_fwd_group(4, 61) == (64, 1, 4)
        assert tk.twist_bwd_group(4, 61, 256, M=Mt) == 1


def test_plans_outside_the_contract():
    with pytest.raises(NotImplementedError):
        tk.twist_fwd_plan(33, 4, 256)
    with pytest.raises(NotImplementedError):
        tk.twist_bwd_plan(4, 65, 256)
    with pytest.raises(NotImplementedError):
        tk.twist_fwd_plan(1, 65, 256)
