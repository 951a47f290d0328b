"""NumPy oracle for the VNCSMC (twisted) recursion.

Literal float64 re-execution of the reference's nested-SMC rank update
(reference vncsmc.py:283-553): per rank, potentials are computed for
every candidate pair x M subparticle branch draws
(vncsmc.py:341-374), log-normalized per particle (vncsmc.py:404-407),
a (pair, m) index is drawn categorically, and the weight update uses the
*log* proposal probability (vncsmc.py:489-491) -- unlike the uniform
VCSMC path, which subtracts the raw probability.

Branch pools and categorical choices are injected; the pool is indexed
by the SAME static lexicographic pair table the twist module uses
(phylo_tpu_torch.smc.twist.upper_tri_pairs), with entries for inactive pairs
ignored.
"""

from __future__ import annotations

import numpy as np
from scipy.special import logsumexp

from phylo_tpu_torch.oracle.reference_vcsmc import (
    OracleVCSMC,
    log_double_factorial_odd,
)
from phylo_tpu_torch.smc.twist import upper_tri_pairs


def _topo_prior(c):
    return -log_double_factorial_odd(2 * max(c, 2) - 3)


class OracleVNCSMC(OracleVCSMC):
    def __init__(self, *args, M=3, **kwargs):
        super().__init__(*args, **kwargs)
        self.M = M

    def run(self, decisions):
        N, K, M = self.N, self.K, self.M
        R = N - 1
        pairs_table = upper_tri_pairs(N)
        core = [[self.leaves[n].copy() for n in range(N)] for _ in range(K)]
        counts = [[1] * N for _ in range(K)]

        log_weights = np.zeros((R, K))
        log_likelihood = np.zeros((R, K))
        tilde = np.full(K, np.log(1.0 / K))
        bl_hist = np.zeros((R, K))
        br_hist = np.zeros((R, K))

        for r in range(R):
            n_active = N - r
            rate_l = self.rates_l[r]
            rate_r = self.rates_r[r]

            if r > 0:
                idx = np.asarray(decisions["ancestors"][r], dtype=int)
                core = [[m.copy() for m in core[i]] for i in idx]
                counts = [list(counts[i]) for i in idx]
                tilde = log_likelihood[r - 1][idx]

            pool_l = np.asarray(decisions["twist_pool_l"][r])  # (P, M, K)
            pool_r = np.asarray(decisions["twist_pool_r"][r])
            choice = np.asarray(decisions["twist_choice"][r], dtype=int)

            valid = [
                p for p in range(len(pairs_table))
                if pairs_table[p, 1] < n_active
            ]

            # potentials in the flat (pair * M + m) layout over the
            # static table, -inf at invalid pairs
            flat = np.full((K, len(pairs_table) * M), -np.inf)
            for p in valid:
                i, j = int(pairs_table[p, 0]), int(pairs_table[p, 1])
                for k in range(K):
                    l_data, r_data = core[k][i], core[k][j]
                    c1, c2 = counts[k][i], counts[k][j]
                    ll_l = self.root_loglik(l_data) + _topo_prior(c1)
                    ll_r = self.root_loglik(r_data) + _topo_prior(c2)
                    for m in range(M):
                        merged = self.conditional_likelihood(
                            l_data, r_data,
                            pool_l[p, m, k], pool_r[p, m, k],
                        )
                        ll_m = (
                            self.root_loglik(merged)
                            + _topo_prior(c1 + c2)
                        )
                        flat[k, p * M + m] = ll_m - ll_l - ll_r
            flat = flat - logsumexp(flat, axis=1, keepdims=True)

            q_log = flat[np.arange(K), choice]
            pair_idx = choice // M
            m_idx = choice % M
            b_l = pool_l[pair_idx, m_idx, np.arange(K)]
            b_r = pool_r[pair_idx, m_idx, np.arange(K)]
            bl_hist[r] = b_l
            br_hist[r] = b_r

            for k in range(K):
                p1 = int(pairs_table[pair_idx[k], 0])
                p2 = int(pairs_table[pair_idx[k], 1])
                new_msg = self.conditional_likelihood(
                    core[k][p1], core[k][p2], b_l[k], b_r[k]
                )
                new_count = counts[k][p1] + counts[k][p2]
                keep = [i for i in range(n_active) if i not in (p1, p2)]
                core[k] = [core[k][i] for i in keep] + [new_msg]
                counts[k] = [counts[k][i] for i in keep] + [new_count]

                ll = self.forest_posterior(core[k], counts[k])
                lp_l = np.sum(-rate_l * bl_hist[: r + 1, k]
                              + np.log(rate_l))
                lp_r = np.sum(-rate_r * br_hist[: r + 1, k]
                              + np.log(rate_r))
                ll = ll + lp_l + lp_r
                log_likelihood[r, k] = ll

                v_minus = sum(c - (1 if c == 1 else 0) for c in counts[k])
                q_branch = (
                    np.log(rate_l) - rate_l * b_l[k]
                    + np.log(rate_r) - rate_r * b_r[k]
                )
                log_weights[r, k] = (
                    ll - tilde[k] - q_branch + np.log(v_minus) - q_log[k]
                )

        elbo = float(np.sum(logsumexp(log_weights - np.log(K), axis=1)))
        return dict(
            log_weights=log_weights,
            log_likelihood=log_likelihood,
            elbo=elbo,
        )
