from phylo_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    TrainResult,
    init_params,
    train,
)
