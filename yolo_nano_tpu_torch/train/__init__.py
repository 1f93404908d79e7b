from yolo_nano_tpu_torch.train.schedule import warmup_step_schedule  # noqa: F401
from yolo_nano_tpu_torch.train.state import (TrainState,  # noqa: F401
                                             create_train_state,
                                             make_optimizer)
from yolo_nano_tpu_torch.train.train_step import make_train_step  # noqa: F401
