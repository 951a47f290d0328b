"""VNCSMC over the spectral models (GY94 codons and a PAML .dat+F+Gamma4
protein model), and the twist's pair chunks sized from a byte budget,
held in float64 on the CPU.

* The port's twist sweep against the JAX package's under injected
  decisions (`test_twist.make_twist_decisions`), 4 taxa, K=4, M=2, 24
  codons or sites: per-rank fields and the ELBO to 1e-9 and the manual
  VJP's gradients against jax.grad to 1e-8, over GY94 with betacorona1's
  F61 frequencies (dense 61 states, the T-field backward) and
  .dat+F+Gamma4 (the port on 4 blocks of 20, JAX dense; the default
  backward).  The JAX sweep runs with `_pair_ll_ref` replaced by an
  einsum of the same function and with its dense rank merge
  (`blocked_merge=False`), as in tests/test_torch_twist_mixture_wide.py.
* A chunked enumeration (a budget that splits the first ranks unevenly,
  and pair_chunk=1) equals one chunk: fields and gradients to 1e-12; the
  forward and the manual VJP's re-evaluation ask `resolve_chunk` the
  same questions and get the same answers.
* The chunk rule as a pure function of shapes: one chunk a rank at every
  twist shape chip_smoke.py's phase 4 ran before the spectral twists
  (primate, DS1 GTR+Gamma4, protein+Gamma4 / +Gamma8, at S=256 and the
  eval's S), more than one at GY94's and GY94+Gamma4's rank 0, each
  chunk within the budget, and pair_chunk winning over it.
* `add_cols`, the 'k' mesh's fixed-order sum of the roots' cotangents,
  against index_add_ (1e-15).
* The eigh kernel's sweep cap in its NumPy transcription: NaN at a cap
  below the sweeps a matrix needs, the same values at that count.
* `--codons=True --nested=True` through the runner on a tiny codon FASTA:
  a finite ELBO and non-zero gradients.
The CUDA side (the kernels at these shapes, the paths at full width) is
chip_smoke.py's."""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.codon import GY94 as JGY94
from phylo_tpu.models.substitution import get_model as j_get_model
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu.smc.twist import TwistConfig as JTwist
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.dataio import codon_dataset, load_dataset
from phylo_tpu_torch.dataio.codons import empirical_codon_frequencies
from phylo_tpu_torch.dataio.simulate import simulate_on_tree
from phylo_tpu_torch.models.codon import GY94
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
from phylo_tpu_torch.train.trainer import _sweep_config, param_tensors
from phylo_tpu_torch.train import TrainConfig

from test_torch_protein import _dat_text
from test_torch_spectral_capture import _generator_S, jacobi_reference
from test_torch_twist_mixture_wide import _jax_ll_einsum
from test_twist import make_twist_decisions

torch.set_num_threads(1)

FIELDS = ("log_weights", "log_likelihood", "elbo", "log_likelihood_R",
          "q_proposal")
N, S, K, M = 4, 24, 4, 2


@functools.lru_cache(maxsize=None)
def _f61():
    """betacorona1's F61 codon frequencies."""
    return empirical_codon_frequencies(
        codon_dataset(load_dataset("betacorona1")).genome)


def _codon_genome(seed):
    """N codon sequences evolved under GY94 (betacorona1's F61, its
    initial kappa and omega) down a 4-taxon tree of branches 0.1: related
    sequences, as an alignment holds.  Uniform random codons, or
    betacorona1's first taxa, sit two or three changes apart at many
    sites; under an injected branch of 1e-3 those sites' likelihoods lean
    on transition entries of 1e-11 and below, which two float64
    eigendecompositions (LAPACK's here, JAX's there) agree on only to
    ~1e-15 absolute: there the particles' log-likelihoods and log weights
    of the two packages differ by up to 5e-7 and 2e-6 relative (VCSMC and
    VNCSMC alike), their ELBOs by 5e-11."""
    model = GY94(_f61())
    params = {"model": model.init_params(dtype=torch.float64)}
    record = {"merges": [[0, 1], [2, 3], [4, 5]],
              "branches": np.full((N - 1, 2), 0.1)}
    g = np.asarray(simulate_on_tree(record, model, params, S,
                                    seed=seed).genome, np.float64)
    g[0, :2] = 1.0                                 # missing codons
    return g


def _protein_genome(seed):
    rng = np.random.default_rng(seed)
    g = np.eye(20)[rng.integers(0, 20, (N, S))]
    g[1, :2] = 1.0                                 # missing residues
    return g


@functools.lru_cache(maxsize=None)
def _dat_path():
    path = os.path.join(tempfile.mkdtemp(), "prot.dat")
    with open(path, "w") as f:
        f.write(_dat_text(300))
    return path


def _models(kind, genome):
    """(JAX model, port model) of one kind on `genome`."""
    if kind == "dat_f_g4":
        spec = f"{_dat_path()}+f+g4"
        return j_get_model(spec, A=20), get_model(spec, A=20)
    return JGY94(_f61()), GY94(_f61())


@functools.lru_cache(maxsize=None)
def _case(kind):
    """numpy inputs and the JAX twist sweep's fields and jax.grad of its
    ELBO, from one compiled value_and_grad."""
    seed = {"gy94": 310, "dat_f_g4": 330}[kind]
    genome = (_protein_genome(seed) if kind == "dat_f_g4"
              else _codon_genome(seed))
    jmodel, _ = _models(kind, genome)
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0.0, 0.3, np.shape(x)), {"model": jmodel.init_params(jnp.float64),
                                 "branches": j_branches(N, dtype=jnp.float64)})
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    leaves = jnp.asarray(jmodel.expand_leaves(genome)
                         if hasattr(jmodel, "expand_leaves") else genome)
    # unroll=1 keeps JAX's rank loop a scan: GY94's sweep compiles in two
    # thirds of the unrolled loop's time, to the same values
    cfg = JConfig(K=K, twist=JTwist(M=M, remat=False), blocked_merge=False,
                  unroll=1)

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


def _grads(params):
    return params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                        is_leaf=torch.is_tensor))


@functools.lru_cache(maxsize=None)
def _run(kind, twist, bwd_v2):
    """The port's sweep on `kind`'s case, its manual-VJP gradients under
    the default backward (K7 / K7 wide's plain version) or the T-field
    one (K11c's): (fields, gradients) as numpy, and the model."""
    case = _case(kind)
    _, model = _models(kind, case["genome"])
    genome = case["genome"]
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    params = params_from_numpy(case["tree"], requires_grad=True)
    old, tk.TWIST_BWD_V2 = tk.TWIST_BWD_V2, bwd_v2
    try:
        res = sample_phylogenies(
            None, torch.tensor(genome), model, params,
            SweepConfig(K=K, twist=twist),
            decisions={k: torch.tensor(v) for k, v in case["dec"].items()})
        res.elbo.backward()
    finally:
        tk.TWIST_BWD_V2 = old
    return ({f: getattr(res, f).detach().numpy() for f in FIELDS},
            _grads(params), model)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


# GY94's reverse pass through the T-field plain backward (K11c's), which
# tests/test_torch_twist_mixture_wide.py holds to K7 wide's to 1e-12: at
# 61 dense states the autograd VJP takes ~10 s on the CPU.  GY94+Gamma4
# is not held to JAX here: JAX's dense 244-state twist sweep took ~105 s
# to compile and run.
CASES = [("gy94", True), ("dat_f_g4", False)]


@pytest.mark.parametrize("kind,bwd_v2", CASES)
def test_twist_spectral_matches_jax(kind, bwd_v2):
    """Per-rank fields and the ELBO to 1e-9 and the manual VJP's
    gradients against jax.grad to 1e-8; .dat+F+Gamma4 takes the blocked
    route (`twist_blocks`: 4 blocks of 20), GY94 the dense one at 61
    states."""
    got, grads, model = _run(kind, tw.TwistConfig(M=M), bwd_v2)
    assert tk.twist_blocks(model) == {"gy94": None,
                                      "dat_f_g4": (4, 20)}[kind]
    want = _case(kind)["want"]
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    for path, w in jax.tree_util.tree_leaves_with_path(_case(kind)["want_g"]):
        g = _leaf(grads, path)
        # the spectral gradients take their scale as a floor, as in
        # tests/test_torch_wide.py and tests/test_torch_protein.py
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


def _split_budget(kind):
    """A chunk_budget_mb that splits the first ranks into uneven chunks
    (2.5 pairs' bytes: rank 0's 6 pairs in 3 chunks, rank 1's 3 in 2)."""
    _, _, model = _run(kind, tw.TwistConfig(M=M), True)
    per = tw.pair_bytes(tw.TwistConfig(M=M), model, K, model.A, S, 8)
    return max(1, int(2.5 * per / 2 ** 20))


@pytest.mark.parametrize("kind,chunking", [("gy94", "budget"),
                                           ("dat_f_g4", "pair_chunk=1")])
def test_chunked_equals_one_chunk(kind, chunking, monkeypatch):
    """A chunked enumeration gives the one-chunk fields to the bit and
    the gradients to 1e-12 (both through the T-field backward), and the
    forward and the reverse pass's re-evaluation resolve the same chunk
    at every rank.  GY94's kappa and omega gradients are held to 1e-10:
    each chunk runs eigh's backward on its own share of the eigenvector
    cotangent, whose F_ij = 1 / (w_j - w_i) multiplies the rounding of
    the chunks' sums (an order of 1e-16) by up to 1 / (relative gap x
    max |w|), GY94's smallest relative gap being ~1e-4 here; they came
    out 2.2e-11 and 3.8e-11 apart (the JAX package chunks its
    re-evaluation alike)."""
    one, one_g, _ = _run(kind, tw.TwistConfig(M=M), True)
    twist = (tw.TwistConfig(M=M, pair_chunk=1) if chunking == "pair_chunk=1"
             else tw.TwistConfig(M=M, chunk_budget_mb=_split_budget(kind)))
    asked = []

    def recorded(*a):
        C = resolve(*a)
        asked.append((a[2:], C))
        return C
    resolve = tw.resolve_chunk
    monkeypatch.setattr(tw, "resolve_chunk", recorded)
    got, grads, _ = _run(kind, twist, True)
    R = N - 1
    fwd, bwd = asked[:R], asked[R:]
    assert len(bwd) == R and sorted(fwd) == sorted(bwd)
    chunks = [C for _, C in fwd]
    assert chunks[0] < fwd[0][0][0]             # rank 0 in several chunks
    assert chunks[:2] == ([2, 2] if chunking == "budget" else [1, 1])
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], one[f], err_msg=f)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        w = _leaf(one_g, path)
        name = jax.tree_util.keystr(path)
        tol = 1e-10 if kind == "gy94" and "model" in name else 1e-12
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max(),
                                   err_msg=name)


# ------------------------------------------------------- the chunk rule
# (spec, taxa, planes, sites of the SGD step and of the eval sweep): the
# twist paths chip_smoke.py's phase 4 ran before the spectral ones
EXISTING = {"primate": ("reference", 12, 4, (256, 898)),
            "ds1_gtr_g4": ("gtr+g4", 27, 16, (256, 1949)),
            "protein_g4": ("reference+g4", 16, 80, (256, 500)),
            "protein_g8": ("reference+g8", 16, 160, (256, 500))}


def _ranks(twist, model, Nt, planes, S_, Kt=32):
    """Each rank's (pairs, chunk) at the runner's K=32, float32."""
    out = []
    for n in range(Nt, 1, -1):
        P = n * (n - 1) // 2
        out.append((P, tw.resolve_chunk(twist, model, P, Kt, planes, S_,
                                        4)))
    return out


@pytest.mark.parametrize("name", sorted(EXISTING))
def test_one_chunk_a_rank_on_the_earlier_paths(name):
    spec, Nt, planes, sites = EXISTING[name]
    model = get_model(spec, A=20 if "reference+" in spec else 4)
    twist = _sweep_config(TrainConfig(nested=True, M=10)).twist
    assert twist.chunk_budget_mb == tw.TwistConfig().chunk_budget_mb
    for S_ in sites:
        assert all(C == P for P, C in _ranks(twist, model, Nt, planes, S_))


@pytest.mark.parametrize("spec,planes,n_chunks", [
    ("gy94", 61, (2, 2)), ("gy94+g4", 244, (5, 6))])
def test_spectral_rank_zero_takes_several_chunks(spec, planes, n_chunks):
    """betacorona1's 17 taxa at the SGD step's 256 codons and the eval's
    1086: rank 0's 136 pairs in several chunks, each within the budget;
    pair_chunk wins over the budget."""
    model = get_model(spec, A=61)
    twist = tw.TwistConfig(M=10)
    budget = twist.chunk_budget_mb * 2 ** 20
    for S_, want in zip((256, 1086), n_chunks):
        ranks = _ranks(twist, model, 17, planes, S_)
        P, C = ranks[0]
        assert -(-P // C) == want
        assert C * tw.pair_bytes(twist, model, 32, planes, S_, 4) <= budget
        assert ranks[-1] == (1, 1)
        assert tw.resolve_chunk(tw.TwistConfig(M=10, pair_chunk=100), model,
                                P, 32, planes, S_, 4) == 100
        assert tw.resolve_chunk(tw.TwistConfig(M=10, pair_chunk=500), model,
                                P, 32, planes, S_, 4) == P


def test_add_cols_equals_index_add():
    """The 'k' mesh's sum of the roots' cotangents in a fixed order
    (`add_cols`) against index_add_, duplicates included."""
    rng = np.random.default_rng(340)
    dst = torch.tensor(rng.normal(size=(3, 7, 5, 11)))
    src = torch.tensor(rng.normal(size=(3, 9, 5, 11)))
    index = torch.tensor([0, 0, 1, 0, 1, 2, 3, 3, 6])
    want = dst.clone().index_add_(1, index, src)
    got = tw.add_cols(dst.clone(), index, src)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-15,
                               atol=1e-15)


def test_jacobi_cap_gives_nan():
    """The eigh kernel's method at a cap below the sweeps a matrix takes:
    NaN in w and U (the cap's count of sweeps); at exactly that many, the
    uncapped values."""
    S_ = _generator_S(np.random.default_rng(61), 61)
    w, U, sweeps = jacobi_reference(S_)
    wc, Uc, sc = jacobi_reference(S_, max_sweeps=sweeps - 1)
    assert np.all(np.isnan(wc)) and np.all(np.isnan(Uc)) and sc == sweeps - 1
    wk, Uk, sk = jacobi_reference(S_, max_sweeps=sweeps)
    assert sk == sweeps and np.array_equal(wk, w) and np.array_equal(Uk, U)


def test_runner_nested_codons_cpu(tmp_path, monkeypatch):
    """One epoch of `--codons=True --nested=True` through runner.run on
    the CPU (the T-field backward, PHYLO_TWIST_BWD_V2's route, whose plain
    version is ~5x quicker at 61 states than the autograd VJP)."""
    monkeypatch.setattr(tk, "TWIST_BWD_V2", True)
    rng = np.random.default_rng(350)
    fasta = tmp_path / "codons.fa"
    seqs = ["".join(rng.choice(list("ACGT"), 12)) for _ in range(4)]
    fasta.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs)))
    res = runner.run([f"--dataset={fasta}", "--codons=True", "--nested=True",
                      "--M=2", "--n_particles=3", "--batch_size=4",
                      "--num_epoch=1", "--no_artifacts", "--device=cpu"])
    assert np.isfinite(res.elbo)
    for t in param_tensors(res.params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert bool((t.grad != 0).any())
