"""precond of the PyTorch/CUDA port (mirrors gmres_tpu/precond)."""
