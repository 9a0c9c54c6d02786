"""Kernel packages of the port: each holds ``ref.py`` (the plain PyTorch
version), ``kernel.py`` (the wrapper of a hand-written CUDA kernel from
``csrc/``) and ``ops.py`` (dispatch by the tensor's device)."""
