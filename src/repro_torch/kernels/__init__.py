"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``hop_megakernel.py`` (the kernel binding and the plain twin),
``ops.py`` (the public entry points), ``dispatch.py`` (launch counters),
``build.py`` (nvcc + ctypes) and ``csrc/`` (the CUDA sources)."""
