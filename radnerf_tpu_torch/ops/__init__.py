"""Ray and field ops of the port (twins of radnerf_tpu/ops)."""
