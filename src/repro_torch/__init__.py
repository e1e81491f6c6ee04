"""PyTorch/CUDA port of the CarbonCall serving stack for one NVIDIA H100.

Mirrors the layout of the JAX package `repro` module for module, so each
port module sits where its counterpart does. The port imports torch and
numpy, never jax and nothing of `repro`. Kernels are hand-written CUDA for
Hopper (`csrc/`), built at first use; on CPU tensors every kernel wrapper
takes its plain PyTorch version. Importing the package is cheap: submodules
load on demand.
"""
