"""The sweep's layout on a device mesh (port of
phylo_tpu/parallel/sharding.py).

The JAX package states the layout as NamedShardings and lets GSPMD
insert the collectives.  Here each process holds its own blocks and the
sweep calls the exchanges itself (parallel.collectives):

* leaves (N, S, A): sites on 's' -- this rank's contiguous site block
  (JAX's P(None, 's', None));
* the message buffer (K, N-1, A, S): particles on 'k', sites on 's';
* per-particle vectors (K,): particles on 'k' (JAX's P('k')) for the
  merge scalars and the twist's candidate log-likelihoods, which are
  gathered over 'k' before anything reads them; the forest's tables
  (positions, leaf counts, weights) are small and every rank keeps all
  K particles' copies, computed alike from the gathered scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phylo_tpu_torch.parallel.mesh import Mesh


@dataclass(frozen=True, eq=False)
class SweepSharding:
    """Which mesh axis holds sites ('s') and which particles ('k'), and
    this rank's blocks of each."""

    mesh: Mesh

    def axis(self, name):
        """The size of axis `name`, 1 where the mesh has no such axis."""
        return self.mesh.shape.get(name, 1)

    @property
    def has_s(self):
        return "s" in self.mesh.axis_names

    @property
    def has_k(self):
        return "k" in self.mesh.axis_names and self.axis("k") > 1

    @property
    def k(self):
        return self.axis("k")

    @property
    def s(self):
        return self.axis("s")

    def group(self, name):
        return self.mesh.groups[name]

    def site_multiple(self):
        """Sites must be padded to a multiple of the 's' axis size."""
        return self.s

    def sites(self, S):
        """This rank's contiguous block of S (padded) sites."""
        if S % self.s:
            raise ValueError(
                f"{S} sites do not split over the 's' axis of size "
                f"{self.s}; pad them first (pad_sites)")
        n = S // self.s
        i = self.mesh.coords.get("s", 0)
        return slice(i * n, (i + 1) * n)

    def particles(self, K):
        """This rank's contiguous block of K particles."""
        if K % self.k:
            raise ValueError(
                f"K={K} particles do not split over the 'k' axis of size "
                f"{self.k}: K must be a multiple of it (the port refuses "
                "where JAX's GSPMD pads; ROADMAP.md Queue 3)")
        n = K // self.k
        i = self.mesh.coords.get("k", 0)
        return slice(i * n, (i + 1) * n)


def sweep_sharding(mesh: Mesh) -> SweepSharding:
    return SweepSharding(mesh=mesh)


def pad_sites(leaves, multiple, site_weights=None):
    """Pad the site axis of (N, S, A) leaves to a multiple of the mesh's
    's' size with all-ones (missing-data) columns, returning
    (padded_leaves, site_weights) where padding sites carry weight 0 so
    they contribute nothing to any log-likelihood reduction."""
    N, S, A = leaves.shape
    pad = (-S) % multiple
    if site_weights is None:
        site_weights = np.ones(S)
    if pad == 0:
        return leaves, np.asarray(site_weights)
    pad_block = np.ones((N, pad, A), dtype=np.asarray(leaves).dtype)
    padded = np.concatenate([np.asarray(leaves), pad_block], axis=1)
    w = np.concatenate([np.asarray(site_weights), np.zeros(pad)])
    return padded, w


def shard_leaves(leaves, shardings):
    """This rank's site block of (N, S, A) leaves (NumPy or torch), or
    the leaves themselves without a mesh."""
    if shardings is None:
        return leaves
    return leaves[:, shardings.sites(leaves.shape[1])]
