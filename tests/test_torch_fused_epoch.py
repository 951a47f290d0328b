"""The fused epoch (TrainConfig.fused_epoch) and the leaf-buffer sweep of
the port, on the CPU.

The CUDA graphs themselves run only on the card (`chip_smoke.py` phase
9 holds fused against the loop there); here: the field and its JAX
default, the fused and loop runs' equal bits on the CPU (which the plan
leaves uncaptured), `capture_plan`'s answers, the rate-mixture memo's
reset after a replay, the launch bookkeeping of a captured graph and a
failed capture raising out of `train` (both with a stand-in for the
graph object), and the cached device constants against the per-call
values they replace.  `make_leaf_buffer` / `sample_phylogenies_with_
buffer` are held to the JAX package's functions in float64 under
injected decisions (1e-9), their buffer reused twice."""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.smc.sweep import make_leaf_buffer as j_make_leaf_buffer
from phylo_tpu.train.trainer import TrainConfig as JTrainConfig
from phylo_tpu_torch import _ext
from phylo_tpu_torch.dataio import load_dataset
from phylo_tpu_torch.device import device_constant
from phylo_tpu_torch.models import expm
from phylo_tpu_torch.models.codon import (
    GY94, _device_masks, _structure_masks,
)
from phylo_tpu_torch.models.empirical import EmpiricalProtein
from phylo_tpu_torch.models.substitution import (
    HKY, FixedQ, GammaSites, ReferenceQ, clear_memos,
)
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.smc.sweep import (
    SweepConfig, make_leaf_buffer, sample_phylogenies,
    sample_phylogenies_with_buffer,
)
from phylo_tpu_torch.train import trainer
from phylo_tpu_torch.train.trainer import (
    TrainConfig, TrainState, capture_plan, param_tensors, train,
)

from test_torch_sweep import (
    assert_parity, jax_sweep, random_genome, setup_case, torch_decisions,
)

torch.set_num_threads(1)


class StandInGraph:
    """The surface of torch.cuda.CUDAGraph that CountedGraph uses, on the
    CPU: capture records nothing (the callable runs eagerly between
    capture_begin and capture_end), a replay runs nothing."""

    def __init__(self, fail_at=None, on_replay=None):
        self.fail_at = fail_at
        self.on_replay = on_replay
        self.generators = []
        self.calls = []

    def register_generator_state(self, g):
        self.generators.append(g)

    def capture_begin(self, pool=None):
        self.calls.append(("begin", pool))
        if self.fail_at == "begin":
            raise RuntimeError("stand-in capture failed")

    def capture_end(self):
        self.calls.append(("end",))
        if self.fail_at == "end":
            raise RuntimeError("stand-in capture failed")

    def replay(self):
        self.calls.append(("replay",))
        if self.on_replay is not None:
            self.on_replay()

    def pool(self):
        return ("stand-in pool", id(self))


def _tiny_primate(**kw):
    cfg = dict(n_particles=4, batch_size=256, num_epoch=2, device="cpu",
               dtype="float64", save_artifacts=False, log_every=1,
               collect_trees=False, seed=3)
    cfg.update(kw)
    return load_dataset("primate_data"), TrainConfig(**cfg)


# ------------------------------------------------------------------ (a)
def test_fused_epoch_field_has_jax_default_and_cpu_bits_match_loop():
    assert TrainConfig().fused_epoch is True
    assert JTrainConfig().fused_epoch is True
    assert TrainState(params={}, opt_state=None).epoch == 0
    ds, cfg = _tiny_primate(optimizer="adam", learning_rate=0.01)
    fused = train(ds, cfg)
    loop = train(ds, TrainConfig(**{**cfg.__dict__, "fused_epoch": False}))
    assert fused.graphs["captured"] is False
    assert fused.elbo == loop.elbo
    assert fused.history["elbo"] == loop.history["elbo"]
    for k in ("log_weights", "Qmatrices", "rates_l", "ancestors"):
        for a, b in zip(fused.history[k], loop.history[k]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(param_tensors(fused.params), param_tensors(loop.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("case", ["cpu", "spectral", "spectral_mixture",
                                  "mesh", "learned_q", "gamma", "off"])
def test_capture_plan(case):
    """Decided from the configuration alone: every model is captured on
    the card (the spectral ones too: the eigengap is decided on the
    device), nothing on the CPU, on a mesh or with fused_epoch off."""
    cfg, dev = TrainConfig(), "cuda"
    want, word = True, "captured"
    if case == "cpu":
        dev, want, word = "cpu", False, "CPU"
    elif case == "spectral":
        cfg = TrainConfig(substitution_model="gy94")
    elif case == "spectral_mixture":
        cfg = TrainConfig(paml_dat="lg.dat", plus_f=True, gamma_categories=4)
    elif case == "mesh":
        cfg, want, word = TrainConfig(mesh_shape=(2,)), False, "mesh"
    elif case == "learned_q":
        cfg = TrainConfig(substitution_model="gtr")
    elif case == "gamma":
        cfg = TrainConfig(substitution_model="gtr", gamma_categories=4)
    elif case == "off":
        cfg, want, word = TrainConfig(fused_epoch=False), False, "off"
    captured, reason = capture_plan(cfg, None, dev)
    assert captured is want and word in reason
    # the device may come from the configuration; None means cuda
    assert capture_plan(TrainConfig(**{**cfg.__dict__, "device": dev})) == (
        captured, reason)


# ------------------------------------------------------------------ (c)
def test_memo_is_cleared_after_a_replay(monkeypatch):
    """A replay writes the parameters in place without bumping their
    versions: the memo would hand back the rates of before; the fused
    epoch's post-replay hook drops it.  The stand-in's replay writes
    log_alpha as a graph's would."""
    model = GammaSites(ReferenceQ(4), G=4)
    params = model.init_params(torch.float64)
    alpha = params["log_alpha"]

    def write():
        alpha.data.copy_(alpha + 0.25)

    monkeypatch.setattr(_ext, "new_graph",
                        lambda: StandInGraph(on_replay=write))
    with torch.no_grad():
        r0 = model._category_rates(params)
        version = alpha._version
        write()
        assert alpha._version == version
        assert torch.equal(model._category_rates(params), r0)   # stale
        clear_memos(model)
        fe = trainer._FusedEpoch(model, {"model": params}, None, None,
                                 torch.zeros((2, 3, 4)), 3,
                                 torch.device("cpu"))
        fn = lambda: model._category_rates(params)  # noqa: E731
        # eager + capture (the memo made inside it); replay; replay
        for seed in (1, 2, 3):
            fe._run("eval", fn, seed)
            assert torch.equal(model._category_rates(params),
                               model.rates(params))
    assert fe.replays() == 2 and float(alpha) == 0.75
    assert "_rates_memo" in model.__dict__
    clear_memos(model)
    assert "_rates_memo" not in model.__dict__


# ------------------------------------------------------------------ (d)
def test_counted_graph_launch_bookkeeping(monkeypatch):
    monkeypatch.setattr(_ext, "new_graph", StandInGraph)
    monkeypatch.setattr(_ext, "LAUNCHES", collections.Counter(k1=5))
    gen = torch.Generator()

    def fn():
        _ext.LAUNCHES["k1"] += 2
        _ext.LAUNCHES["k5"] += 1
        return "static outputs"

    g = _ext.CountedGraph("cpu", generators=(gen,), pool="p")
    resets = []
    assert g.capture(fn, reset=lambda: resets.append(
        dict(_ext.LAUNCHES))) == ("static outputs", "static outputs")
    # the eager warm-up counts, before the reset; the capture launches
    # nothing
    assert resets == [{"k1": 7, "k5": 1}]
    assert _ext.LAUNCHES == {"k1": 7, "k5": 1}
    assert g.launches == {"k1": 2, "k5": 1}
    assert g.graph.generators == [gen]
    assert g.graph.calls == [("begin", "p"), ("end",)]
    for _ in range(3):
        g.replay()
    assert _ext.LAUNCHES == {"k1": 13, "k5": 4} and g.replays == 3


@pytest.mark.parametrize("fail_at", ["begin", "end"])
def test_failed_capture_raises_out_of_train(monkeypatch, fail_at):
    """No fallback to the loop: the capture's error leaves `train`, and
    the counts are as they were before the capture."""
    monkeypatch.setattr(_ext, "new_graph",
                        lambda: StandInGraph(fail_at=fail_at))
    monkeypatch.setattr(trainer, "capture_plan",
                        lambda *a: (True, "captured (forced)"))
    monkeypatch.setattr(_ext, "LAUNCHES", collections.Counter(k1=7))
    ds = load_dataset("load_strings")
    cfg = TrainConfig(n_particles=3, batch_size=5, num_epoch=2,
                      device="cpu", dtype="float64", save_artifacts=False,
                      log_every=0)
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        train(ds, cfg)
    assert _ext.LAUNCHES == {"k1": 7}


# ------------------------------------------------------------------ (e)
def test_cached_constants_equal_the_per_call_values():
    f64 = torch.float64
    cpu = torch.device("cpu")
    q = np.arange(16.0).reshape(4, 4) / 10.0
    fq = FixedQ(q, stationary=[0.1, 0.2, 0.3, 0.4])
    assert torch.equal(fq.Q({}), torch.tensor(fq._Q, dtype=f64))
    assert fq.Q({}) is fq.Q({}, device="cpu")          # made once
    assert torch.equal(fq.stationary({}, dtype=torch.float32),
                       torch.tensor(fq._pi, dtype=torch.float32))
    mask = torch.tensor(HKY._TRANSITION_MASK) == 1
    hky = HKY()
    p = {k: v + 0.1 for k, v in hky.init_params(f64).items()}
    assert torch.equal(device_constant(HKY._TRANSITION_MASK, torch.bool,
                                       cpu), mask)
    pi = hky.stationary(p)
    off = torch.where(mask, torch.exp(p["log_kappa"]), torch.ones(())) \
        * pi[None, :] * (1.0 - torch.eye(4, dtype=f64))
    want = off - torch.diag(off.sum(1))
    want = want / -(pi * torch.diagonal(want)).sum()
    assert torch.equal(hky.Q(p), want)
    n_max = 160
    n = np.arange(1, n_max + 1, dtype=np.float64)
    lg = np.array([math.lgamma(v + 1.0) for v in n])
    c_n = lg - (n * np.log(n) - n + 0.5 * np.log(2.0 * np.pi * n))
    got = device_constant(expm._stirling_residuals(n_max), f64, cpu)
    assert torch.equal(got, torch.tensor(c_n))
    gy = GY94(np.linspace(1.0, 2.0, 61))
    for a, b in zip(_device_masks(f64, cpu), _structure_masks()):
        assert torch.equal(a, torch.tensor(b, dtype=f64))
    assert torch.equal(gy.stationary({}), torch.tensor(gy._freqs))
    exch = np.ones((20, 20)) - np.eye(20)
    emp = EmpiricalProtein(exch, np.full(20, 0.05))
    qe = emp.Q({})
    s = torch.tensor(emp._exch, dtype=f64)
    ref = s * torch.tensor(emp._freqs)[None, :]
    ref = ref - torch.diag(ref.sum(1))
    ref = ref / -(torch.tensor(emp._freqs) * torch.diagonal(ref)).sum()
    assert torch.equal(qe, ref)


# ------------------------------------------------------ the leaf buffer
def test_make_leaf_buffer_matches_jax():
    genome = random_genome(11, N=5, S=17)
    got = make_leaf_buffer(torch.tensor(genome), SweepConfig(K=3))
    want = j_make_leaf_buffer(jnp.asarray(genome), _jconfig(3))
    assert got.shape == want.shape == (3, 9, 4, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jconfig(K):
    from phylo_tpu.smc.sweep import SweepConfig as JConfig

    return JConfig(K=K)


@pytest.mark.parametrize("model_name", ["jc69", "reference"])
def test_buffered_sweep_matches_jax_and_reuses_its_buffer(model_name):
    genome = random_genome(21, N=6, S=23)
    K = 5
    jmodel, tmodel, tree, dec = setup_case(genome, model_name, K, seed=22)
    want = jax_sweep(genome, jmodel, tree, dec, K)
    leaves = torch.tensor(genome)
    params = params_from_numpy(tree, requires_grad=False)
    buf = make_leaf_buffer(leaves, SweepConfig(K=K), model=tmodel)
    leaf_cols = buf[:, :6].clone()
    for _ in range(2):
        res, out = sample_phylogenies_with_buffer(
            None, leaves, tmodel, params, SweepConfig(K=K), buf,
            decisions=torch_decisions(dec))
        assert out is buf
        assert_parity(res, want)
        assert torch.equal(buf[:, :6], leaf_cols)      # leaves untouched
        assert torch.count_nonzero(buf[:, 6:]) > 0      # merges written
    # seeded: the same bits as the plain sweep from the same seed
    g = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    plain = sample_phylogenies(g(), leaves, tmodel, params, SweepConfig(K=K))
    for _ in range(2):
        res, buf = sample_phylogenies_with_buffer(
            g(), leaves, tmodel, params, SweepConfig(K=K), buf)
        assert torch.equal(res.elbo, plain.elbo)
        assert torch.equal(res.log_weights, plain.log_weights)
    with pytest.raises(ValueError, match="make_leaf_buffer"):
        sample_phylogenies_with_buffer(
            g(), leaves, tmodel, params, SweepConfig(K=K + 1), buf)

