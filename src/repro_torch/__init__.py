"""PyTorch/CUDA port of the hybrid KNN-join (``repro``'s JAX package is
the reference it is tested against).

Every module sits at the same relative path as the JAX module it ports.
Entry points take an explicit ``device`` and default to ``"cuda"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version, on a
CUDA tensor it launches the hand-written Hopper kernel in ``csrc/``."""
