"""Renderers of the port (twins of radnerf_tpu/render)."""
