"""Field models of the port (twins of radnerf_tpu/models)."""
