"""The command line: ``python -m viscoin_tpu_torch train viscoin ...``."""
