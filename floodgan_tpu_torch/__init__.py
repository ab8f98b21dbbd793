"""PyTorch/CUDA port of floodgan_tpu for NVIDIA Hopper (H100).

The first slice serves PairedAttention: the attention generator in image
space, its two fusion kernels written by hand in CUDA C++ for ``sm_90a``
(``csrc/``), and the inference engine, micro-batcher and HTTP frontend of
``serve.py``.  Tensors are NCHW-contiguous inside the port; the engine's
public API stays NHWC, as in the JAX package.

Importing the package builds nothing: the kernels are compiled with nvcc
at their first launch on a CUDA tensor (``ops/_build.py``).
"""
