"""CLI layer: the ``crf-decode`` twin (PyTorch / CUDA)."""
