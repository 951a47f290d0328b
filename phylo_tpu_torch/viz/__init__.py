from phylo_tpu_torch.viz.trees import (  # noqa: F401
    decode_genealogy,
    merge_name_chains,
    to_newick,
    tree_probabilities,
)
