"""The PyTorch/CUDA port's benchmark: see README.md."""
