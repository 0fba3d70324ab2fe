"""What the drivers share: the seeds of a run, the configuration's system
and reference modules, and the device's bookkeeping."""

from __future__ import annotations

import gc
import importlib

import torch

SEED_MOD = 2 ** 63 - 1


def seeds(seed: int) -> dict:
    """The run's seeds, one per input, from --seed (any whole number)."""
    s = int(seed) % SEED_MOD
    return {k: (s + i) % SEED_MOD for i, k in enumerate(
        ("weights", "gen", "check"))}


def system(conf: dict):
    return importlib.import_module(f"benchmark.systems.{conf['system']}")


def reference(conf: dict):
    return importlib.import_module(
        f"benchmark.reference.{conf['reference']}")


def check_train(tcfg, train: dict, traffic: dict) -> None:
    """Raise where the program's training options are not the
    configuration's and the traffic's (the reference takes those)."""
    want = {"lr": train["lr"], "opacity_loss_w": train["opacity_loss_w"],
            "cv_loss_w": train["cv_loss_w"],
            "depth_mutual_loss_w": train.get("depth_mutual_loss_w", 0.0),
            "budget_per_ray": train["budget_per_ray"],
            "adaptive_budget": train.get("adaptive_budget", True),
            "warmup_steps": train["warmup_steps"],
            "batch_size": traffic["batch_size"],
            "microbatch": traffic["microbatch"]}
    got = {k: getattr(tcfg, k) for k in want}
    if got != want:
        raise ValueError(f"the program's options {got} are not the "
                         f"configuration's {want}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
