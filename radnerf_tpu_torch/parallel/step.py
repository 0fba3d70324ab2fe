"""The data-parallel training step (twin of radnerf_tpu/parallel/step.py).

The reference writes its step against one device's shard of rays and lays
it over the `ray` mesh axis with shard_map, `pmean`ing the gradients,
the loss and the floating aux. In the port every rank runs the step on
its own block of the batch (`shard_batch`) and, after its accumulation
slices, averages the same values across the ranks with one all-reduce of
a flat buffer (`all_reduce_mean`: a sum, then a division by the number of
ranks, as pmean's psum then divide). Every rank then takes the same Adam
update from the same bits. `broadcast_from_main` hands every rank rank
0's copy of state that each rank computes for itself (the density grids).

Parameters are pytrees of plain dicts and lists of leaf tensors, as in
the JAX package; gradients come back in the same structure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import trace
from .mesh import Mesh


def tree_leaves(tree) -> list:
    """Leaf tensors of a dict/list tree, in JAX's order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list[str]:
    """The path of every leaf of `tree_leaves(tree)`, in the same order:
    dict keys and list indices joined by '/' (e.g. 'model/geo/w/0')."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def tree_unflatten(tree, leaves: list):
    """`tree`'s structure filled with `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def microbatched_value_and_grad(loss3, microbatch: int):
    """Gradient accumulation: split the batch into `microbatch` contiguous
    slices along its leading axis, run them one after another and average
    (loss, aux, grads).

    `loss3(params, batch, *args) -> (loss, aux)`; `aux` is a dict of
    scalars. Per-ray randomness travels in the batch, so slicing does not
    change it; batch-statistic loss terms (the MoE cv load-balance loss)
    become per-slice estimates, averaged, as in the reference."""

    def vg(params, batch: dict, *args):
        leaves = tree_leaves(params)
        n = next(iter(batch.values())).shape[0]
        if n % microbatch:
            raise ValueError(
                f"batch {n} not divisible by microbatch {microbatch}")
        size = n // microbatch
        loss_sum, aux_sum, grad_sum = 0.0, None, None
        for i in range(microbatch):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            with trace.span("step.slice"):
                loss, aux = loss3(params, part, *args)
            with trace.span("step.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            aux = {k: v.detach().to(torch.float32) for k, v in aux.items()}
            loss_sum = loss_sum + loss.detach()
            if grad_sum is None:
                aux_sum, grad_sum = aux, grads
            else:
                aux_sum = {k: aux_sum[k] + aux[k] for k in aux}
                grad_sum = [a + b for a, b in zip(grad_sum, grads)]
        inv = 1.0 / microbatch
        return (loss_sum * inv, {k: v * inv for k, v in aux_sum.items()}), \
            tree_unflatten(params, [g * inv for g in grad_sum])

    return vg


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's contiguous block of every leaf's leading axis, the
    blocks in rank order (P("ray")'s layout). ValueError where the batch
    does not divide by the number of ranks."""
    if mesh is None or mesh.size == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} not divisible by {mesh.size} ranks")
    size = n // mesh.size
    lo = mesh.rank * size
    return {k: v[lo:lo + size] for k, v in batch.items()}


def all_reduce_mean(tensors: list, mesh: Mesh | None) -> list:
    """pmean over the ranks: the tensors flattened into one float32
    buffer, one all-reduce (sum), a division by the number of ranks, and
    the buffer cut back into the tensors' shapes and dtypes. At one rank
    the tensors themselves."""
    if mesh is None or mesh.size == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def broadcast_from_main(tensors: list, mesh: Mesh | None) -> None:
    """Overwrite each tensor, in place, with rank 0's (a no-op at one
    rank); booleans travel as bytes."""
    if mesh is None or mesh.size == 1:
        return
    for t in tensors:
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                       src=0)


def pmean_step_values(loss, aux: dict, grads: list, mesh: Mesh | None):
    """(loss, aux, grads) averaged over the ranks in one all-reduce: the
    loss, every floating aux value and every gradient leaf; other aux
    values stay this rank's."""
    if mesh is None or mesh.size == 1:
        return loss, aux, grads
    fkeys = [k for k, v in aux.items() if torch.is_floating_point(v)]
    with trace.span("step.allreduce"):
        vals = all_reduce_mean([loss, *(aux[k] for k in fkeys), *grads],
                               mesh)
    return (vals[0], {**aux, **dict(zip(fkeys, vals[1:1 + len(fkeys)]))},
            vals[1 + len(fkeys):])


def make_train_step(loss_fn, optimizer: torch.optim.Optimizer,
                    microbatch: int = 0, mesh: Mesh | None = None):
    """The data-parallel training step of one rank.

    `loss_fn(params, model_state, batch, data) -> (loss, aux)`, written
    for this rank's block of the batch; `optimizer` holds the leaves of
    `params` (tree_leaves order). With microbatch > 1 the block is split
    into that many accumulation slices. With a mesh of several ranks the
    loss, the floating aux and the gradients are then averaged over them
    (one all-reduce) before the update. Returns step(params, model_state,
    batch, data) -> (loss, aux), which updates `params` in place."""

    def step(params, model_state, batch, data):
        vg = microbatched_value_and_grad(
            lambda p, b: loss_fn(p, model_state, b, data), max(1, microbatch))
        (loss, aux), grads = vg(params, batch)
        loss, aux, grads = pmean_step_values(loss, aux, tree_leaves(grads),
                                             mesh)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        with trace.span("step.adam"):
            optimizer.step()
        return loss, aux

    return step


def make_grad_fn(loss_fn, mesh: Mesh | None):
    """(loss, grads) averaged over the ranks: make_train_step's core
    without accumulation slices or optimizer. Returns grad_fn(params,
    model_state, batch, data) -> (loss, grads), `batch` this rank's
    block, `grads` in the structure of `params`."""

    def grad_fn(params, model_state, batch, data):
        leaves = tree_leaves(params)
        loss, _ = loss_fn(params, model_state, batch, data)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss, _, grads = pmean_step_values(loss.detach(), {}, grads, mesh)
        return loss, tree_unflatten(params, grads)

    return grad_fn
