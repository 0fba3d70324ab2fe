"""The training step on one device (twin of radnerf_tpu/parallel/step.py
without the data-parallel mesh, which is queued in ROADMAP.md).

Parameters are pytrees of plain dicts and lists of leaf tensors, as in
the JAX package; gradients come back in the same structure.
"""

from __future__ import annotations

import torch


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
            loss, aux = loss3(params, part, *args)
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


def make_train_step(loss_fn, optimizer: torch.optim.Optimizer,
                    microbatch: int = 0):
    """The one-device training step.

    `loss_fn(params, model_state, batch, data) -> (loss, aux)`;
    `optimizer` holds the leaves of `params` (tree_leaves order). With
    microbatch > 1 the batch is split into that many accumulation slices.
    Returns step(params, model_state, batch, data) -> (loss, aux), which
    updates `params` in place."""

    def step(params, model_state, batch, data):
        vg = microbatched_value_and_grad(
            lambda p, b: loss_fn(p, model_state, b, data), max(1, microbatch))
        (loss, aux), grads = vg(params, batch)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        optimizer.step()
        return loss, aux

    return step
