"""The spectral transitions with their eigengap decided on the device
(phylo_tpu_torch.models.expm.expm_reversible) and the eigh that a CUDA
graph can hold (phylo_tpu_torch.models.eigh_kernel), float64 on the CPU:

* `expm_reversible` against the JAX package's in both branches (GY94's
  generator; JC69 on 9 states, whose spectrum collapses): values to
  1e-9, gradients in Q, pi and b against jax.grad to 1e-8; the collapsed
  case's gradient finite and the chain's;
* the eigh autograd.Function (its plain forward, torch.linalg.eigh)
  against torch.linalg.eigh's autograd and by gradcheck at 20 and 61
  states; a zero cotangent over tied eigenvalues gives zero, not NaN;
* the Jacobi kernel's method (round-robin order, threshold, ascending
  sort), transcribed in NumPy, against torch.linalg.eigh at 20, 61 and
  64 states and the collapsed 9-state matrix, with its sweep count; its
  order a permutation with NaN on the diagonal, and NaN out of a
  non-finite matrix;
* no host read: `expm_reversible`, GY94's, GY94+G4's and .dat+F+G4's
  transitions and a GY94 fixed-decision sweep with its gradients run
  with torch.Tensor.item, __float__ and __bool__ raising;
* the GY94 fixed-decision sweep and its gradients still the JAX sweep's
  (1e-9 / 1e-8);
* the twist's fixed-order gather (smc.twist.gather_cols, root_ll's
  gather in the potential terms on every device, whose cotangent
  torch.gather would sum with float atomics on the card): the same
  values and gradients as torch.gather to the bit, and the potential
  terms through it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import expm as jexpm
from phylo_tpu_torch.models import eigh_kernel
from phylo_tpu_torch.models import expm as texpm
from phylo_tpu_torch.models.codon import GY94
from phylo_tpu_torch.models.empirical import EmpiricalProtein
from phylo_tpu_torch.models.substitution import GammaSites
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.smc import twist
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_torch_codon import _reversible_case
from test_torch_sweep import torch_decisions
from test_torch_wide import _jax_case

torch.set_num_threads(1)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


def _generator_S(rng, A):
    pi = rng.dirichlet(np.ones(A))
    E = rng.gamma(1.0, size=(A, A))
    E = (E + E.T) / 2
    Q = E * pi[None]
    np.fill_diagonal(Q, 0.0)
    Q -= np.diag(Q.sum(1))
    Q /= -np.sum(pi * np.diag(Q))
    d = np.sqrt(pi)
    S = Q * (d[:, None] / d[None])
    return (S + S.T) / 2


# ------------------------------------------------------- expm_reversible
@pytest.mark.parametrize("collapsed", [False, True])
def test_expm_reversible_value_and_gradients_match_jax(collapsed):
    Q, pi = _reversible_case(collapsed)
    A = Q.shape[0]
    rng = np.random.default_rng(7)
    b = rng.exponential(0.3, 5)
    G = rng.normal(size=(5, A, A))

    def jloss(Q, pi, b):
        return jnp.sum(jnp.asarray(G) * jexpm.expm_reversible(Q, pi, b))

    jval = jexpm.expm_reversible(jnp.asarray(Q), jnp.asarray(pi),
                                 jnp.asarray(b))
    jgrad = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(Q), jnp.asarray(pi), jnp.asarray(b))
    ts = [torch.tensor(x, requires_grad=True) for x in (Q, pi, b)]
    P = texpm.expm_reversible(*ts)
    _close(P.detach(), jval, 1e-9)
    grads = torch.autograd.grad(torch.sum(torch.tensor(G) * P), ts)
    for g, w in zip(grads, jgrad):
        assert torch.all(torch.isfinite(g))
        _close(g, w, 1e-8)
    if collapsed:
        # the chain's gradient alone: the spectral branch adds exact zeros
        ts2 = [torch.tensor(x, requires_grad=True) for x in (Q, b)]
        chain = texpm.expm_ctmc(ts2[0].T, ts2[1])
        want = torch.autograd.grad(torch.sum(torch.tensor(G) * chain), ts2)
        assert torch.equal(grads[0], want[0])
        assert torch.equal(grads[2], want[1])
        assert torch.equal(grads[1], torch.zeros_like(grads[1]))


# ------------------------------------------------------------------ eigh
def _composite(fn, A, seed):
    """A gauge-invariant scalar vector of eigh's outputs, from a free
    (A, A) input symmetrised first (eigh reads one triangle)."""
    rng = np.random.default_rng(seed)
    S0 = torch.tensor(_generator_S(rng, A))
    G = torch.tensor(rng.normal(size=(A, A)))

    def f(X):
        w, U = fn(S0 + (X + X.T) / 2)
        P = (U * torch.exp(0.3 * w)) @ U.T
        return torch.stack([torch.sum(G * P), torch.sum(w * w),
                            P[0, 1] + w[-1]])
    return f


@pytest.mark.parametrize("A", [20, 61])
def test_eigh_function_matches_linalg_eigh(A):
    f_mine = _composite(eigh_kernel.eigh, A, A)
    f_torch = _composite(torch.linalg.eigh, A, A)
    X = torch.tensor(np.random.default_rng(1).normal(0, 1e-3, (A, A)),
                     requires_grad=True)
    y1, y2 = f_mine(X), f_torch(X)
    assert torch.equal(y1, y2)
    for i in range(3):
        g1, = torch.autograd.grad(y1[i], X, retain_graph=True)
        g2, = torch.autograd.grad(y2[i], X, retain_graph=True)
        _close(g1, g2, 1e-10)
    if A == 20:
        assert torch.autograd.gradcheck(f_mine, (X,), eps=1e-6, atol=1e-6)
    else:
        # gradcheck over 61 x 61 inputs takes minutes; one directional
        # derivative by central differences instead
        V = torch.tensor(np.random.default_rng(2).normal(size=(A, A)))
        h = 1e-5
        with torch.no_grad():
            fd = (f_mine(X + h * V) - f_mine(X - h * V)) / (2 * h)
        for i in range(3):
            g, = torch.autograd.grad(y1[i], X, retain_graph=True)
            _close(torch.sum(g * V), fd[i], 1e-6)


def test_eigh_zero_cotangent_over_ties_is_zero():
    """JC69 on 9 states: eight equal eigenvalues.  A zero cotangent gives
    an exactly zero S_bar (F_ij = 0 on ties); torch.linalg.eigh's own
    backward divides by the zero gaps."""
    S = torch.tensor(np.full((9, 9), 1.0 / 9) - np.eye(9),
                     requires_grad=True)
    w, U = eigh_kernel.eigh(S)
    assert torch.min(torch.diff(w.detach())) < 1e-12
    g, = torch.autograd.grad((w, U), S, (torch.zeros_like(w),
                                         torch.zeros_like(U)))
    assert torch.equal(g, torch.zeros_like(g))
    X = torch.diag(torch.tensor([1.0, 1.0, 2.0], dtype=torch.float64))
    X.requires_grad_(True)
    w, U = eigh_kernel.eigh(X)
    g, = torch.autograd.grad((w, U), X, (torch.zeros_like(w),
                                         torch.zeros_like(U)))
    assert torch.equal(g, torch.zeros_like(g))
    w, U = torch.linalg.eigh(X)
    g, = torch.autograd.grad((w, U), X, (torch.zeros_like(w),
                                         torch.zeros_like(U)))
    assert not torch.all(torch.isfinite(g))


def jacobi_reference(S, tol_scale=1e-18, max_sweeps=40):
    """The CUDA kernel's method in NumPy: pad to even n_p, round-robin
    rounds of n_p / 2 disjoint rotations (Golub & Van Loan's sym.schur2
    in the kernel's form, t = sign(d) h / (|d| + sqrt(d^2 + h^2)),
    skipped where |a_pq| <= tol_scale ||S||_F), sweeps until one applies
    none; eigenvalues ascending (ties by index, NaN last: `ranks`); a
    NaN or an infinity in S gives NaN everywhere and 0 sweeps, and a
    matrix whose max_sweeps-th sweep still rotated NaN everywhere and
    max_sweeps sweeps.  Returns (w, U, sweeps)."""
    n = S.shape[0]
    if not np.all(np.isfinite(S)):
        return np.full(n, np.nan), np.full((n, n), np.nan), 0
    n_p = n + (n & 1)
    m = n_p // 2
    a = np.zeros((n_p, n_p))
    a[:n, :n] = S
    v = np.eye(n_p)
    tol = tol_scale * np.sqrt(np.sum(S * S))
    sweeps = 0
    while sweeps < max_sweeps:
        sweeps += 1
        rotated = False
        for r in range(n_p - 1):
            J = np.eye(n_p)
            diag = []
            for k in range(m):
                x, y = ((n_p - 1, r) if k == 0 else
                        ((r + k) % (n_p - 1), (r - k) % (n_p - 1)))
                p, q = min(x, y), max(x, y)
                apq = a[p, q]
                if abs(apq) > tol:
                    d, h = a[q, q] - a[p, p], 2 * apq
                    t = h / (abs(d) + np.sqrt(d * d + h * h))
                    t = -t if d < 0 else t
                    c = 1 / np.sqrt(t * t + 1)
                    J[p, p] = J[q, q] = c
                    J[p, q], J[q, p] = t * c, -t * c
                    diag.append((p, q, a[p, p] - t * apq,
                                 a[q, q] + t * apq))
                    rotated = True
            a = J.T @ a @ J
            for p, q, app, aqq in diag:
                a[p, p], a[q, q], a[p, q], a[q, p] = app, aqq, 0.0, 0.0
            v = v @ J
        if not rotated:
            break
    else:
        return np.full(n, np.nan), np.full((n, n), np.nan), sweeps
    w = np.diag(a)[:n]
    order = np.argsort(ranks(w))
    return w[order], v[:n, :n][:, order], sweeps


def ranks(w):
    """Each entry's place in the kernel's ascending order
    (`sorts_before`: numbers by value, NaN after them, equal keys by
    index), counted as the kernel counts it: the entries before it."""
    def before(x, j, y, i):
        if np.isnan(x) != np.isnan(y):
            return bool(np.isnan(y))
        if np.isnan(x):
            return j < i
        return x < y or (x == y and j < i)
    return np.array([sum(before(w[j], j, w[i], i) for j in range(len(w)))
                     for i in range(len(w))])


@pytest.mark.parametrize("case", ["20", "61", "64", "jc69_9"])
def test_jacobi_method_matches_linalg_eigh(case):
    if case == "jc69_9":
        S = np.full((9, 9), 1.0 / 9) - np.eye(9)
    else:
        S = _generator_S(np.random.default_rng(int(case)), int(case))
    w, U, sweeps = jacobi_reference(S)
    wr = np.linalg.eigvalsh(S)
    A = S.shape[0]
    assert np.max(np.abs(w - wr)) <= 1e-13 * np.max(np.abs(wr))
    assert np.max(np.abs((U * w) @ U.T - S)) <= 1e-13
    assert np.max(np.abs(U.T @ U - np.eye(A))) <= 1e-13
    assert 2 <= sweeps <= 12


def test_jacobi_order_is_a_permutation_with_nan():
    """The kernel's ranks stay a permutation with NaN on the diagonal
    (with `<` alone every NaN would take rank 0), and a non-finite S
    gives NaN everywhere, not an error."""
    w = np.array([np.nan, 1.0, np.nan, -np.inf, 1.0, 0.0, np.inf, -0.0])
    r = ranks(w)
    assert sorted(r) == list(range(len(w)))
    np.testing.assert_array_equal(np.argsort(r), [3, 5, 7, 1, 4, 6, 0, 2])
    assert np.array_equal(np.argsort(r), np.argsort(w, kind="stable"))
    S = _generator_S(np.random.default_rng(5), 20)
    for bad in (np.nan, np.inf):
        X = S.copy()
        X[3, 17] = X[17, 3] = bad
        wk, U, sweeps = jacobi_reference(X)
        assert np.all(np.isnan(wk)) and np.all(np.isnan(U)) and sweeps == 0


def test_eigh_refuses_what_the_kernel_does_not_take():
    S = torch.eye(3, dtype=torch.float64)
    w, U, sweeps = eigh_kernel.eigh_fwd(S)       # the CPU: linalg.eigh
    assert sweeps is None and torch.equal(w, torch.ones(3,
                                                        dtype=w.dtype))
    assert eigh_kernel.MAX_A == 64


# ------------------------------------------------------- no host reads
@pytest.fixture
def no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a host read of a tensor")

    def arm():
        for name in ("item", "__float__", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
    return arm


def _dat_model():
    rng = np.random.default_rng(3)
    E = rng.lognormal(size=(20, 20))
    return EmpiricalProtein((E + E.T) / 2 * (1 - np.eye(20)),
                            rng.random(20) + 0.5, plus_f=True)


@pytest.mark.parametrize("model_name", ["expm_reversible", "gy94",
                                        "gy94+g4", "dat+f+g4"])
def test_no_host_read_in_the_spectral_transitions(model_name,
                                                  no_host_reads,
                                                  monkeypatch):
    b = torch.tensor(np.random.default_rng(4).exponential(0.2, (3, 4)))
    if model_name == "expm_reversible":
        cases = [_reversible_case(c) for c in (False, True)]
        args = [[torch.tensor(Q, requires_grad=True),
                 torch.tensor(pi, requires_grad=True)] for Q, pi in cases]
        want = [texpm.expm_reversible(Q, pi, b) for Q, pi in args]
        no_host_reads()
        got = [texpm.expm_reversible(Q, pi, b) for Q, pi in args]
        grads = [torch.autograd.grad(P.sum(), a) for P, a in zip(got, args)]
        monkeypatch.undo()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert all(torch.all(torch.isfinite(x)) for g in grads for x in g)
        return
    model = {"gy94": lambda: GY94(plus_f=True),
             "gy94+g4": lambda: GammaSites(GY94(), G=4),
             "dat+f+g4": lambda: GammaSites(_dat_model(), G=4)}[model_name]()
    params = model.init_params(torch.float64)
    leaves = [t for t in jax.tree_util.tree_leaves(
        params, is_leaf=torch.is_tensor)]
    for t in leaves:
        t.requires_grad_(True)
    fn = (model.transition_blocks if hasattr(model, "transition_blocks")
          else model.transition)
    want = fn(params, b)
    no_host_reads()
    P = fn(params, b)
    grads = torch.autograd.grad(P.sum(), leaves)
    monkeypatch.undo()
    assert torch.equal(P, want)
    assert all(torch.all(torch.isfinite(g)) for g in grads)


# ------------------------------------------------------------ the sweep
@pytest.mark.parametrize("host_reads", ["allowed", "refused"])
def test_gy94_fixed_decision_sweep_matches_jax(host_reads, no_host_reads,
                                               monkeypatch):
    """GY94+F on 5 codon taxa, K=4, injected decisions, the manual VJP:
    ELBO to 1e-9 and every gradient to 1e-8 of the JAX sweep's, with the
    host reads refused too (the sweep's own and the transitions')."""
    genome, freqs, tree, dec, K, want_elbo, want_grad = _jax_case()
    model = GY94(freqs, plus_f=True)
    params = params_from_numpy(tree)
    if host_reads == "refused":
        no_host_reads()
    res = sample_phylogenies(None, torch.tensor(genome), model, params,
                             SweepConfig(K=K),
                             decisions=torch_decisions(dec))
    res.elbo.backward()
    monkeypatch.undo()
    np.testing.assert_allclose(float(res.elbo.detach()), want_elbo,
                               rtol=1e-9)
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    for path, w in jax.tree_util.tree_leaves_with_path(want_grad):
        g = got
        for p in path:
            g = g[p.key]
        _close(g, w, 1e-8)


# ---------------------------------------------- the twist's fixed order
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_order_gather_is_torch_gather(dtype):
    """Every root of a 27-taxon forest in its 26 pairs (the twist's
    rank-0 positions), 32 particles: `gather_cols` gives torch.gather's
    values and cotangent to the bit."""
    N, K = 27, 32
    pairs = twist._tables(N, "cpu")[0][:N * (N - 1) // 2]
    pos = twist.pair_positions(pairs, K)
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(K, N)), dtype=dtype)
    g = torch.tensor(rng.normal(size=tuple(pos.shape)), dtype=dtype)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    assert twist.gather_cols == twist._FixedOrderGather.apply
    ya = twist.gather_cols(xa, pos)
    yb = torch.gather(xb, 1, pos)
    assert torch.equal(ya, yb)
    ga, = torch.autograd.grad(ya, xa, g)
    gb, = torch.autograd.grad(yb, xb, g)
    assert torch.equal(ga, gb)


def test_pot_terms_gather_root_ll_through_the_fixed_order(monkeypatch):
    """The potential terms take root_ll through `gather_cols` on every
    device: their values and root_ll's gradient are those of
    torch.gather in its place, to the bit."""
    N, K = 7, 5
    pairs = twist._tables(N, "cpu")[0][:N * (N - 1) // 2]
    slot = torch.arange(N)[None].expand(K, N)
    counts = torch.ones((K, N), dtype=torch.int64)
    rows = torch.zeros((K, N - 1), dtype=torch.int64)
    root_ll = torch.tensor(np.random.default_rng(3).normal(size=(K, N)),
                           requires_grad=True)

    def terms():
        t = twist.pot_terms(pairs, slot, counts, rows, None, root_ll, N,
                            torch.float64)
        return t, torch.autograd.grad(torch.sum(t * t), root_ll)[0]

    got = terms()
    seen = []
    monkeypatch.setattr(twist, "gather_cols",
                        lambda x, index: seen.append(x) or torch.gather(
                            x, 1, index))
    want = terms()
    assert len(seen) == 1 and seen[0] is root_ll
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
