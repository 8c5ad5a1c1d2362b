"""Reporting and profiling utilities (mirrors gmres_tpu/utils)."""
