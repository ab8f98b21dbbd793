"""The public training API of the port (``Model``) and its artifact paths."""

from floodgan_tpu_torch.api.model import Model

__all__ = ["Model"]
