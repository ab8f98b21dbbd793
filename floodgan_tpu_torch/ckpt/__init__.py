"""Checkpoints: the JAX package's ``.ckpt`` format, read and written
without msgpack or flax, and the reference's ``.pth.tar`` files."""

from floodgan_tpu_torch.ckpt.checkpoint import AsyncCheckpointer, BF16Array, load_checkpoint, save_checkpoint

__all__ = ["AsyncCheckpointer", "BF16Array", "load_checkpoint", "save_checkpoint"]
