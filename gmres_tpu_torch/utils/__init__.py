"""Reporting, checkpointing, debugging and profiling utilities (mirrors
gmres_tpu/utils)."""
