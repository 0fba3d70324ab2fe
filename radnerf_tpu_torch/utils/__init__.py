"""Logging and checkpoints (twin of radnerf_tpu/utils/), and the
program's spans and counters (trace.py)."""
