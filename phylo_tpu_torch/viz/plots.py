"""Phylogeny drawing (networkx) -- the reference's Graph/draw capability
(reference csmc.py:104-122: DiGraph + kamada-kawai layout); port of
phylo_tpu/viz/plots.py.

Import-guarded: drawing is optional and never on the compute path.
"""

from __future__ import annotations


def build_digraph(taxa, record):
    """networkx DiGraph of one decoded particle's tree (edges parent ->
    child), nodes labeled with clade names."""
    import networkx as nx

    from phylo_tpu_torch.viz.trees import _node_namer

    N = len(taxa)
    merges = record["merges"]
    name = _node_namer(taxa, merges)
    g = nx.DiGraph()
    for q in range(merges.shape[0]):
        parent = name(N + q)
        c1, c2 = merges[q]
        g.add_edge(parent, name(int(c1)))
        g.add_edge(parent, name(int(c2)))
    return g


def draw_tree(taxa, record, prob=None, path=None, show=False):
    """Draw one sampled genealogy (reference csmc.py:114-122); saves to
    `path` when given."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    g = build_digraph(taxa, record)
    plt.figure(figsize=(10, 10))
    pos = nx.kamada_kawai_layout(g)
    nx.draw_networkx(
        g, pos=pos, with_labels=True, width=3.8, node_color="r",
        edge_color="brown", font_size=6,
    )
    plt.title("Sampled Genealogy", fontsize=14)
    if prob is not None:
        plt.xlabel(f"Prob {prob:1.5f}")
    if path:
        plt.savefig(path)
    if show:  # pragma: no cover
        plt.show()
    plt.close()
    return g
