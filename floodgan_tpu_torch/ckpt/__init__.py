"""Checkpoints: the JAX package's ``.ckpt`` format, read and written
without msgpack or flax, and the reference's ``.pth.tar`` files."""

from floodgan_tpu_torch.ckpt.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint

__all__ = ["AsyncCheckpointer", "load_checkpoint", "save_checkpoint"]
