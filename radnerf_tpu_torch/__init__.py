"""PyTorch + CUDA port of radnerf_tpu for NVIDIA Hopper (H100).

The JAX package `radnerf_tpu` is the reference; this package mirrors its
layout and public signatures, and replaces each Pallas TPU kernel with a
hand-written CUDA kernel (sources in `csrc/`, built at first use by
`kernels.py`). It imports neither JAX nor anything of `radnerf_tpu`.

Entry points create their tensors on `DEFAULT_DEVICE` ("cuda") unless the
caller passes `device="cpu"`. Every op runs where its input tensors live:
on CPU tensors a kernel's wrapper takes its plain PyTorch version, on CUDA
tensors it launches the kernel.

Ported so far: the Rad-NeRF MoE test-time render (`render.ml_render.
ml_render_test`, union sampling, flat layout, brick3 hash encode).
"""

DEFAULT_DEVICE = "cuda"
