from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    model_rows,
    pad_batch_to_multiple,
    replicated,
    shard_model,
    shard_reads,
)
from .train_step import TrainBatch, TrainStepResult, make_train_step  # noqa: F401
