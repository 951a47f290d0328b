"""NumPy re-execution of the exact reference VCSMC weight recursion.

This is the golden oracle for parity tests: a literal, loop-based float64
implementation of the reference rank update (reference vcsmc.py:332-451),
including its quirks:

* the topology proposal penalty subtracts the raw probability
  q = 1/C(n,2), not log q (vcsmc.py:298,392);
* the cumulative branch prior prices every branch sampled so far with the
  *current* rank's rate (vcsmc.py:378-384);
* the branch-length history is NOT re-gathered at resampling
  (vcsmc.py:318-325);
* get_log_likelihood uses the left rates for the right multiplier
  (vcsmc.py:262);
* log-likelihood-tilde initializes to log(1/K) (vcsmc.py:422).

Randomness (ancestor indices, coalesced pair positions, branch lengths)
is injected, so the JAX sweep and this oracle can be driven with identical
decisions and compared to float tolerance.  Positions refer to the
compacted ordering: remaining roots in ascending previous-position order,
the merged root appended last -- the same ordering the JAX sweep uses
(the reference shuffles remaining roots by Gumbel rank, vcsmc.py:305-306,
which is distributionally irrelevant for the uniform proposal).
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm as scipy_expm
from scipy.special import gammaln, logsumexp


def log_double_factorial_odd(n):
    n = np.asarray(n, dtype=np.float64)
    k = (n + 1.0) / 2.0
    return gammaln(2 * k + 1) - k * np.log(2.0) - gammaln(k + 1)


class OracleVCSMC:
    """Literal reference recursion; float64; decision-injected."""

    def __init__(self, genome_NxSxA, Q, stationary, rates_l, rates_r, K,
                 q_raw_subtraction=True, resample_branch_history=False,
                 right_multiplier_bug=True):
        self.leaves = np.asarray(genome_NxSxA, dtype=np.float64)
        self.N, self.S, self.A = self.leaves.shape
        self.Q = np.asarray(Q, dtype=np.float64)
        self.pi = np.asarray(stationary, dtype=np.float64)
        self.rates_l = np.asarray(rates_l, dtype=np.float64)
        self.rates_r = np.asarray(rates_r, dtype=np.float64)
        self.K = K
        self.q_raw = q_raw_subtraction
        self.resample_branch_history = resample_branch_history
        self.right_multiplier_bug = right_multiplier_bug

    # -- reference kernels, literal ------------------------------------
    def conditional_likelihood(self, l_data, r_data, b_l, b_r):
        """reference vcsmc.py:150-161 / 180-188, one particle."""
        P_l = scipy_expm(self.Q * b_l)
        P_r = scipy_expm(self.Q * b_r)
        return (l_data @ P_l) * (r_data @ P_r)

    def root_loglik(self, msg):
        """sum_s log(pi . msg_s), reference vcsmc.py:240-242."""
        return float(np.sum(np.log(msg @ self.pi)))

    def forest_posterior(self, core_k, counts_k):
        """Full-forest recomputation, reference vcsmc.py:231-245."""
        data_ll = sum(self.root_loglik(m) for m in core_k)
        topo = -log_double_factorial_odd(
            2 * np.maximum(np.asarray(counts_k), 2) - 3
        ).sum()
        return data_ll + topo

    def run(self, decisions):
        """decisions: dict with 'ancestors' (R, K), 'pairs' (R, K, 2)
        positions, 'branches_l'/'branches_r' (R, K).  Returns a dict of
        trajectories."""
        N, K = self.N, self.K
        R = N - 1
        core = [
            [self.leaves[n].copy() for n in range(N)] for _ in range(K)
        ]
        counts = [[1] * N for _ in range(K)]

        log_weights = np.zeros((R, K))
        log_likelihood = np.zeros((R, K))
        tilde = np.full(K, np.log(1.0 / K))
        bl_hist = np.zeros((R, K))
        br_hist = np.zeros((R, K))
        v_minus_hist = np.zeros((R, K))

        for r in range(R):
            n_active = N - r
            rate_l = self.rates_l[r]
            rate_r = self.rates_r[r]

            if r > 0:
                idx = np.asarray(decisions["ancestors"][r], dtype=int)
                core = [
                    [m.copy() for m in core[i]] for i in idx
                ]
                counts = [list(counts[i]) for i in idx]
                tilde = log_likelihood[r - 1][idx]
                if self.resample_branch_history:
                    bl_hist[:r] = bl_hist[:r][:, idx]
                    br_hist[:r] = br_hist[:r][:, idx]

            pairs = np.asarray(decisions["pairs"][r], dtype=int)
            b_l = np.asarray(decisions["branches_l"][r], dtype=np.float64)
            b_r = np.asarray(decisions["branches_r"][r], dtype=np.float64)
            bl_hist[r] = b_l
            br_hist[r] = b_r

            q_pairs = n_active * (n_active - 1) / 2.0
            q_pen = (1.0 / q_pairs) if self.q_raw else -np.log(q_pairs)

            for k in range(K):
                p1, p2 = int(pairs[k, 0]), int(pairs[k, 1])
                new_msg = self.conditional_likelihood(
                    core[k][p1], core[k][p2], b_l[k], b_r[k]
                )
                new_count = counts[k][p1] + counts[k][p2]
                # compact: remaining ascending + merged appended
                keep = [
                    i for i in range(n_active) if i not in (p1, p2)
                ]
                core[k] = [core[k][i] for i in keep] + [new_msg]
                counts[k] = [counts[k][i] for i in keep] + [new_count]

                # forest posterior + cumulative branch prior at rank-r
                # rates (reference vcsmc.py:376-384)
                ll = self.forest_posterior(core[k], counts[k])
                lp_l = np.sum(-rate_l * bl_hist[: r + 1, k]
                              + np.log(rate_l))
                lp_r = np.sum(-rate_r * br_hist[: r + 1, k]
                              + np.log(rate_r))
                ll = ll + lp_l + lp_r
                log_likelihood[r, k] = ll

                v_minus = sum(
                    c - (1 if c == 1 else 0) for c in counts[k]
                )
                v_minus_hist[r, k] = v_minus
                q_branch = (
                    np.log(rate_l) - rate_l * b_l[k]
                    + np.log(rate_r) - rate_r * b_r[k]
                )
                log_weights[r, k] = (
                    ll - tilde[k] - q_branch + np.log(v_minus) - q_pen
                )

        elbo = float(
            np.sum(logsumexp(log_weights - np.log(K), axis=1))
        )

        # de-biased data log-likelihood, reference vcsmc.py:254-268
        lp_l = np.sum(
            np.log(self.rates_l)[:, None] - self.rates_l[:, None] * bl_hist,
            axis=0,
        )
        r_mult = self.rates_l if self.right_multiplier_bug else self.rates_r
        lp_r = np.sum(
            np.log(r_mult)[:, None] - self.rates_r[:, None] * br_hist,
            axis=0,
        )
        log_likelihood_R = (
            log_likelihood[-1]
            + log_double_factorial_odd(2 * N - 3)
            - lp_l - lp_r
        )

        return dict(
            log_weights=log_weights,
            log_likelihood=log_likelihood,
            elbo=elbo,
            log_likelihood_R=log_likelihood_R,
            v_minus=v_minus_hist,
        )
