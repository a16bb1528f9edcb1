"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA Hopper card.

Module paths mirror ``src/repro/``. The port imports ``torch`` and numpy and
nothing of JAX or of the JAX package. Kernels live in ``kernels/`` as CUDA
sources built at first use; on a CPU tensor every kernel wrapper takes its
plain PyTorch version instead.
"""
