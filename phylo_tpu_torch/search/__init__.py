from phylo_tpu_torch.search.nj import (  # noqa: F401
    jc_distance_matrix,
    neighbor_joining,
    p_distance_matrix,
)
from phylo_tpu_torch.search.nni import (  # noqa: F401
    NNISearchResult,
    TreeSearchResult,
    hill_climb,
    nni_neighbors,
    nni_search,
    records_to_decisions,
    tree_log_likelihoods_batch,
)
from phylo_tpu_torch.search.spr import (  # noqa: F401
    spr_neighborhood_size,
    spr_neighbors,
    spr_search,
)
