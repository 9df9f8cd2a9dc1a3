"""repro_torch.checkpoint — atomic, hash-verified, keep-last-k checkpoints
with an async writer (port of ``repro/checkpoint``; the same on-disk
format)."""
from .manager import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]
