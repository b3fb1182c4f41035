"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of the
reference: ``<name>/kernel.py`` launches ``csrc/<name>.cu``, ``ref.py`` is
the plain PyTorch version, ``ops.py`` dispatches by the tensor's device."""
