from repro_torch.train.loop import TrainState, make_train_step
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["OptConfig", "TrainState", "adamw_init", "adamw_update",
           "make_train_step"]
