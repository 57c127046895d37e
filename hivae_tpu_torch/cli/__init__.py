"""Command-line entry points of the port, run as
``python -m hivae_tpu_torch.cli.<name>``."""
