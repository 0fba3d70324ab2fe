"""Training step (twin of radnerf_tpu/parallel/step.py, one device)."""
