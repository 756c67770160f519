"""PyTorch + CUDA port of the NestedFP dual-precision serving system.

The JAX package `repro` is the reference; this package imports nothing
of it. Plain tensor code is PyTorch; the kernels of the serving path are
CUDA C++ written for Hopper (`csrc/`), built with nvcc at first use and
bound with ctypes (`kernels/_build.py`). A CPU tensor takes each
kernel's plain PyTorch version instead, which is how the tests check the
port against the JAX package.
"""
