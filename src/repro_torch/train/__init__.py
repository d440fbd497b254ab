from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import StepConfig, build_train_step
from repro_torch.train.loop import TrainLoopConfig, train_loop

__all__ = ["TrainState", "init_state", "StepConfig", "build_train_step",
           "TrainLoopConfig", "train_loop"]
