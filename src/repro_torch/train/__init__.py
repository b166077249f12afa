"""Training-loop substrate of the port: checkpointed, resumable,
metric-logging (``repro.train``)."""
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

__all__ = ["TrainLoop", "TrainLoopConfig"]
