"""Qd-tree learned data layouts on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``, module by module under the same
names.  It imports neither JAX nor ``repro``.  Entry points run on the
GPU unless the caller passes ``device="cpu"``; the four kernels of the
LayoutEngine's main path are CUDA C++ under ``kernels/csrc``, built with
nvcc at first use (``kernels/_build.py``).
"""
