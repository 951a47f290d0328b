from phylo_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    TrainResult,
    init_params,
    train,
)
from phylo_tpu_torch.train.elastic import train_elastic  # noqa: F401
