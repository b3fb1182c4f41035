"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

Mirrors the JAX package's layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) so every module has one counterpart
path. Imports ``torch`` only — never JAX and never the JAX package. The hot
kernels (``qmatvec``, ``qmatmul``, ``attn_decode``, ``attn_prefill``) are
CUDA C++ under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
