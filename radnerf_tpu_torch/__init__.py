"""PyTorch + CUDA port of radnerf_tpu for NVIDIA Hopper (H100).

The JAX package `radnerf_tpu` is the reference; this package mirrors its
layout and public signatures, and replaces each Pallas TPU kernel with a
hand-written CUDA kernel (sources in `csrc/`, built at first use by
`kernels.py`). It imports neither JAX nor anything of `radnerf_tpu`.

Entry points create their tensors on `DEFAULT_DEVICE` ("cuda") unless the
caller passes `device="cpu"`. Every op runs where its input tensors live:
on CPU tensors a kernel's wrapper takes its plain PyTorch version, on CUDA
tensors it launches the kernel.

Ported so far, on the flat sample layout, in bfloat16 or float32, with
every hash-grid family that `hash_impl` selects (`ops.hashgrid.
encode_dispatch`: the tcnn hash, slab, brick, brick3): the Rad-NeRF MoE
render and training step (`render.ml_render`, `train.trainer.Trainer`)
with union sampling, per-expert marches or a hash table per expert; the
single NGP field (`render.render`); train_other.py's Switch-, Block- and
Mega-NeRF baselines (`models.switch`, `models.block`,
`render.switch_render`, `render.block_render`,
`train.other_trainer`); the entry points of train_ml.py, train.py,
train_other.py and oracle.py with every dataset loader (`train_ml`,
`train`, `train_other`, `oracle`: `python -m radnerf_tpu_torch.
train_other --model_type switch ...` on the card, `train_other.main(
argv, device="cpu")` on the CPU); and the measurement scripts of
examples/ (`examples`).
"""

DEFAULT_DEVICE = "cuda"
