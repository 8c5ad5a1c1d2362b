"""solvers of the PyTorch/CUDA port (mirrors gmres_tpu/solvers)."""
