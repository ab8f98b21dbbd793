"""Measurement tools of the port, each run as ``python -m floodgan_tpu_torch.tools.<name>``."""
