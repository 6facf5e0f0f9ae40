"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel package holds ``csrc/`` (the CUDA source), ``ops.py`` (build,
``ctypes`` binding and dispatch: the kernel on CUDA tensors, the plain version
on CPU tensors) and ``ref.py`` (the plain version).
"""
