from phylo_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    is_multiprocess,
    process_summary,
)
from phylo_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from phylo_tpu_torch.parallel.sharding import (  # noqa: F401
    SweepSharding,
    pad_sites,
    shard_leaves,
    sweep_sharding,
)
