"""Data parallelism over rays (twin of radnerf_tpu/parallel/): one rank
per device, parameters and density grids replicated, the ray batch split
into one block per rank, and the gradients, the loss and the floating aux
averaged over the ranks in the step. Every draw comes from a generator
seeded alike on every rank, which draws the whole batch there and so
stays in lock-step. Unlike the reference, whose replicas compute
bit-identical grids, each grid update ends with a broadcast of rank 0's
grids: a cell drawn twice keeps an arbitrary one of its draws."""

from .mesh import (  # noqa: F401
    Mesh, distributed_is_initialized, initialize_multihost, launch,
    make_mesh,
)
from .step import make_grad_fn, make_train_step, shard_batch  # noqa: F401
