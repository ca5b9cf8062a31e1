"""PyTorch and CUDA port of the lip-reading system.

The JAX package ``lipreading_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU, and on the CPU where a caller
asks for it (``device="cpu"``). Module names mirror the JAX package. The
kernels that the JAX package wrote in Pallas are CUDA C++ here
(``csrc/``), built with ``nvcc`` at first use (``kernels.py``).
"""
