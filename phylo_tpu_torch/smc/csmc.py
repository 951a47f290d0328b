"""Plain (non-variational) Combinatorial SMC sampler (port of
phylo_tpu/smc/csmc.py, the reference's oracle).

The reference ships this as a self-contained NumPy oracle
(reference csmc.py:129-454): fixed rate matrix, FIXED branch lengths
(bl1 = bl2 = 2, csmc.py:254-255), uniform pair proposal, optional
multinomial resampling, and a weight recursion

    log w_i = log pi(s_i) - log pi~(s_{i-1}) + log(1/rho) - log q

where rho is the number of non-trivial roots (csmc.py:328-333 -- note
the oracle's overcounting convention 1/rho differs from VCSMC's
v_minus) and pi~ is evaluated on a RANDOM particle's previous forest
(csmc.py:390-396).  Outputs: per-rank weights, aggregated tree posterior
probabilities (csmc.py:335-349), and the normalization-constant estimate
prod_i mean_k w_ik (csmc.py:351-355).

The random draws are NumPy's ``default_rng(seed)`` in the oracle's order
(resampling, the random pi~ particles, then each particle's pair), so one
seed gives the JAX package's `merged_nodes` and `ancestors` exactly.  The
K particles' messages are float64 tensors on the chosen device, each
rank's merges vectorized over K.  No kernel runs here, so float64 is
used on the card too (`device.resolve_dtype`'s float32-on-cuda rule is
about the kernels).  P = expm(Q bl) comes from the port's own delta-form
chain (`models.expm.expm_chain`) in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_tpu_torch.device import resolve_device
from phylo_tpu_torch.models.expm import expm_chain

DEFAULT_Q4 = (
    np.array(
        [
            [-1.0, 0.25, 0.5, 0.25],
            [0.25, -1.0, 0.25, 0.5],
            [0.5, 0.25, -1.0, 0.25],
            [0.25, 0.5, 0.25, -1.0],
        ]
    )
    / 10.0
)  # reference csmc.py:145-148


class CSMC:
    """CSMC over a PhyloDataset-style (taxa, genome) input, on `device`
    (default the card; 'cpu' on request)."""

    def __init__(self, datadict, Q=None, branch_length=2.0, seed=0,
                 device=None):
        self.taxa = list(datadict["taxa"] if isinstance(datadict, dict)
                         else datadict.taxa)
        genome = (datadict["genome"] if isinstance(datadict, dict)
                  else datadict.genome)
        self.device = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.leaves = torch.as_tensor(np.asarray(genome, np.float64), **f64)
        self.N, self.S, self.A = self.leaves.shape
        Q = np.asarray(Q if Q is not None else DEFAULT_Q4, dtype=np.float64)
        if Q.shape[0] != self.A:
            raise ValueError(
                f"Q is {Q.shape[0]}x{Q.shape[0]} but data has "
                f"A={self.A} states"
            )
        self.Q = Q
        self.prior = torch.full((self.A,), 1.0 / self.A, **f64)
        self.bl = float(branch_length)
        self.P = expm_chain(torch.as_tensor(Q, **f64),
                            torch.tensor(self.bl, **f64))
        self.rng = np.random.default_rng(seed)

    def _root_loglik(self, msg):
        """sum_s log(msg_s . prior) of messages (..., S, A)."""
        return torch.sum(torch.log(msg @ self.prior), dim=-1)

    def sample_phylogenies(self, K, resampling=False, showing=False,
                           save_path=None):
        """Run the sampler; returns a result dict with log_weights
        (K, N-1), tree_probabilities, norm, the decoded genealogy,
        ancestors and merged_nodes (host NumPy).

        showing: draw the max-posterior-probability tree labeled with
        its probability (reference csmc.py:450-452).  The figure is
        saved to ``save_path`` (default ``max_prob_tree.png`` in the
        cwd); the networkx DiGraph is returned under 'graph'.
        """
        N, K = self.N, int(K)
        R = N - 1
        dev = self.device
        ar = torch.arange(K, device=dev)
        # each particle's messages and root log-liks by node id (internal
        # node N + i is rank i's merge); pos[k] lists the particle's
        # active roots in the oracle's order
        msgs = torch.zeros((K, 2 * N - 1, self.S, self.A),
                           dtype=torch.float64, device=dev)
        msgs[:, :N] = self.leaves
        node_ll = torch.zeros((K, 2 * N - 1), dtype=torch.float64,
                              device=dev)
        node_ll[:, :N] = self._root_loglik(self.leaves)
        pos = np.tile(np.arange(N), (K, 1))
        log_weights = np.zeros((K, R))
        ancestors = np.zeros((R, K), dtype=np.int64)
        merged_nodes = np.zeros((R, K, 2), dtype=np.int64)
        prev_forest_ll = node_ll[0, :N].sum().expand(K).cpu().numpy()

        for i in range(R):
            n = N - i
            ancestors[i] = np.arange(K)
            if resampling and i > 0:
                w = np.exp(log_weights[:, i - 1]
                           - log_weights[:, i - 1].max())
                idx = self.rng.choice(K, K, p=w / w.sum())
                t_idx = torch.as_tensor(idx, device=dev)
                msgs, node_ll = msgs[t_idx], node_ll[t_idx]
                pos = pos[idx]
                prev_forest_ll = prev_forest_ll[idx]
                ancestors[i] = idx

            # pi~ from a RANDOM particle's previous forest
            # (reference csmc.py:390-396)
            tilde = np.zeros(K)
            if i > 0:
                rand_idx = self.rng.integers(0, K, size=K)
                tilde = prev_forest_ll[rand_idx]

            q = 1.0 / (n * (n - 1) / 2.0)
            picks = np.array([self.rng.choice(n, size=2, replace=False)
                              for _ in range(K)])
            nodes = np.take_along_axis(pos, picks, axis=1)    # (K, 2)
            merged_nodes[i] = nodes
            t_nodes = torch.as_tensor(nodes, device=dev)
            msg = ((msgs[ar, t_nodes[:, 0]] @ self.P)
                   * (msgs[ar, t_nodes[:, 1]] @ self.P))
            msgs[:, N + i] = msg
            node_ll[:, N + i] = self._root_loglik(msg)
            keep = np.ones((K, n), dtype=bool)
            keep[np.arange(K)[:, None], picks] = False
            pos = np.concatenate(
                [pos[keep].reshape(K, n - 2), np.full((K, 1), N + i)],
                axis=1)
            t_pos = torch.as_tensor(pos, device=dev)
            new_ll = torch.gather(node_ll, 1, t_pos).sum(dim=1)
            new_ll = new_ll.cpu().numpy()
            rho = (pos >= N).sum(axis=1)
            if i > 0:
                log_weights[:, i] = (new_ll - tilde + np.log(1.0 / rho)
                                     - np.log(q))
            prev_forest_ll = new_ll

        from phylo_tpu_torch.viz.trees import (
            decode_genealogy,
            tree_probabilities,
        )

        genealogy = decode_genealogy(ancestors, merged_nodes)
        weights = np.exp(log_weights)
        weights[:, 0] = 1.0
        probs = tree_probabilities(
            self.taxa, genealogy, log_weights[:, -1]
        )
        # norm = prod_{i=1..N-2} mean_k w_ik (reference csmc.py:351-355)
        norm = float(np.prod(weights[:, 1:].mean(axis=0)))
        result = dict(
            log_weights=log_weights,
            tree_probabilities=probs,
            norm=norm,
            genealogy=genealogy,
            ancestors=ancestors,
            merged_nodes=merged_nodes,
        )
        if showing:
            from phylo_tpu_torch.viz.plots import draw_tree

            best_prob, best_k = probs[0]
            path = save_path or "max_prob_tree.png"
            result["graph"] = draw_tree(
                self.taxa, genealogy[best_k], prob=best_prob, path=path
            )
            result["max_prob_tree_png"] = path
        return result
