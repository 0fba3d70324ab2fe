"""Logging and checkpoints (twin of radnerf_tpu/utils/)."""
