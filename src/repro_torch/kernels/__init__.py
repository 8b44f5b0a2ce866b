"""The port's kernels: CUDA C++ sources under ``csrc/``, their wrappers,
and a plain PyTorch version beside each."""
