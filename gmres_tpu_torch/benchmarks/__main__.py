"""``python -m gmres_tpu_torch.benchmarks <subcommand> [options]``."""

from gmres_tpu_torch.benchmarks.cli import main

main()
