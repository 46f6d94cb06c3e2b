from .checkpoint import CheckpointManager
from .loop import TrainLoop, TrainLoopConfig, reassign_shards

__all__ = ["CheckpointManager", "TrainLoop", "TrainLoopConfig", "reassign_shards"]
