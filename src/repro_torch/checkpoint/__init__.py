from .ckpt import save_checkpoint, restore_checkpoint, latest_step

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
