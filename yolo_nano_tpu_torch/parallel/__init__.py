from yolo_nano_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
)
