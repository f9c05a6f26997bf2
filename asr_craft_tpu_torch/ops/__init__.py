"""Plain PyTorch dynamic programs: the references the CUDA kernels meet."""
