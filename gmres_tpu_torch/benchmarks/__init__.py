"""Driver programs of the PyTorch/CUDA port (mirrors benchmarks/cli.py)."""
