"""PyTorch/CUDA port of floodgan_tpu for NVIDIA Hopper (H100).

It serves and trains PairedAttention: the attention generator in image
space and the InstanceNorm PatchGAN; the four fusion kernels (instance
norm and attention compose, each forward and backward) written by hand in
CUDA C++ for ``sm_90a`` (``csrc/``); the inference engine, micro-batcher
and HTTP frontend of ``serve.py``; and the paired trainer of
``train/paired.py``.  Tensors are NCHW-contiguous inside the port; the
public APIs stay NHWC, as in the JAX package.

Importing the package builds nothing: the kernels are compiled with nvcc
at their first launch on a CUDA tensor (``ops/_build.py``).
"""
