"""Command-line entry points: ``train`` (and ``--check_data``), ``evaluate``."""
