"""Training loop pieces (twin of radnerf_tpu/train/)."""
