"""Rad-NeRF MoE training on one device (twin of the training-step half of
radnerf_tpu/train/trainer.py; the NeRFSystem shell, data loaders,
logging, validation and checkpoints are queued in ROADMAP.md).

The step: gate, one union march, one shared hash encode (the family of
`MNGPConfig.hash_impl` and `compute_dtype`), per-expert MLPs and flat
compositing, nerf_loss, backward, Adam (eps 1e-15) at the
cosine learning rate. Beside it the density grids are updated every 16
steps (every cell below `warmup_steps`) and the flat-layout sample
budget is re-picked from the measured buffer utilization (the
reference's --adaptive_budget, on by default; the fixed budget comes
with the NeRFSystem shell). Batches are drawn on the device from a device-resident ray
store; the per-ray start jitter is drawn from a torch.Generator and
travels in the batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..losses import nerf_loss, total_loss
from ..metrics import psnr as psnr_fn
from ..models.mngp import MNGPConfig, mngp_update_density_grids
from ..parallel.step import make_train_step, tree_leaves
from ..render.ml_render import get_rays, ml_render_train
from ..render.render import RenderConfig

MAX_SAMPLES = 1024
UPDATE_INTERVAL = 16
# flat-layout sample-budget buckets (--adaptive_budget)
BUDGET_BUCKETS = (16, 24, 32, 40, 48, 56, 64, 80, 96, 112)
DENSITY_THRESHOLD = 0.01 * MAX_SAMPLES / math.sqrt(3)
MICROBATCH_RAYS = 2048        # rays per accumulation slice (auto rule)


def next_budget_bucket(
    cur: int, util: float, buckets: tuple = BUDGET_BUCKETS
) -> int:
    """Pick budget_per_ray from measured utilization, with hysteresis:
    grow when the buffer saturates (>95%: the march is truncating),
    shrink when underused (<45%), targeting ~70% post-shrink."""
    if util <= 0.0:
        return cur
    if util > 0.95:
        bigger = [b for b in buckets if b > cur]
        return bigger[0] if bigger else cur
    if util < 0.45:
        smaller = [b for b in buckets if b < cur]
        want = cur * util / 0.7
        for b in smaller:                 # smallest bucket covering ~70%
            if b >= want:
                return b
        return smaller[-1] if smaller else cur
    return cur


def budget_buckets(n_experts: int) -> tuple:
    """The bucket ladder, extended up to K x for the MoE union stream."""
    return tuple(sorted(
        set(BUDGET_BUCKETS)
        | {b * k for b in (64, 80, 96) for k in range(2, n_experts + 1)}
    ))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The trainer's options on this path. Defaults: the Rad-NeRF
    headline run (scripts/rad_TAT.sh: 20 epochs, batch 8192, lr 1e-2,
    ray gate, cv 1e-2, depth-mutual 5e-3) with opt.py's other defaults."""

    lr: float = 1e-2
    num_epochs: int = 20
    steps_per_epoch: int = 1000
    batch_size: int = 8192
    microbatch: int = 0              # 0: one slice per 2048 rays
    warmup_steps: int = 256
    samples_per_ray: int = 192
    budget_per_ray: int = 64
    gate_type: str = "ray"
    opacity_loss_w: float = 1e-3
    distortion_loss_w: float = 0.0
    cv_loss_w: float = 1e-2
    depth_mutual_loss_w: float = 5e-3

    @property
    def n_microbatch(self) -> int:
        if self.microbatch:
            return self.microbatch
        return max(1, -(-self.batch_size // MICROBATCH_RAYS))


def render_config(cfg: MNGPConfig, tcfg: TrainConfig) -> RenderConfig:
    """The trainer's render settings: a constant-dt lattice and white
    background at scale <= 0.5, the flat layout, and a union budget
    governed by the bucket ladder (the adaptive budget: factor 1)."""
    return RenderConfig(
        exp_step_factor=1 / 256 if cfg.scale > 0.5 else 0.0,
        samples_per_ray=tcfg.samples_per_ray,
        layout="flat",
        budget_per_ray=tcfg.budget_per_ray,
        union_budget_factor=1.0,
    )


def lr_schedule(tcfg: TrainConfig, step: int) -> float:
    """Cosine annealing per epoch from lr to lr / 30."""
    eta_min = tcfg.lr / 30
    epoch = min(step // tcfg.steps_per_epoch, tcfg.num_epochs)
    return eta_min + 0.5 * (tcfg.lr - eta_min) * (
        1 + math.cos(math.pi * epoch / tcfg.num_epochs))


def loss_fn(bundle: dict, model_state: dict, batch: dict, data: dict,
            cfg: MNGPConfig, rcfg: RenderConfig, tcfg: TrainConfig):
    """(loss, aux) of a batch {img_idxs, pix_idxs, noise} over the ray
    store `data` {rays, poses, directions, mean_dir}; bundle {model,
    gate}. aux: psnr, rm_samples, budget_util."""
    poses = data["poses"][batch["img_idxs"]]
    rays_o, rays_d = get_rays(data["directions"][batch["pix_idxs"]], poses)
    imgs_d = get_rays(data["mean_dir"].expand(poses.shape[0], 3), poses)[1]
    target = {"rgb": data["rays"][batch["img_idxs"], batch["pix_idxs"]][:, :3]}
    out = ml_render_train(
        bundle["model"], model_state, cfg, bundle["gate"],
        rays_o.contiguous(), rays_d.contiguous(), imgs_d, rcfg,
        tcfg.gate_type, noise=batch["noise"],
    )
    ld = nerf_loss(
        out, target,
        lambda_opacity=tcfg.opacity_loss_w,
        lambda_distortion=tcfg.distortion_loss_w,
        lambda_cv_importance=tcfg.cv_loss_w,
        lambda_depth_mutual=tcfg.depth_mutual_loss_w,
    )
    aux = {
        "psnr": psnr_fn(out["rgb"], target["rgb"]),
        "rm_samples": out["rm_samples"].to(torch.float32),
        "budget_util": out["budget_util"],
    }
    return total_loss(ld), aux


def sample_batch(gen: torch.Generator, data: dict, batch_size: int) -> dict:
    """Uniform (image, pixel) draws and the per-ray start jitter, on the
    ray store's device."""
    dev = data["directions"].device
    n_img, n_pix = data["poses"].shape[0], data["directions"].shape[0]
    return {
        "img_idxs": torch.randint(0, n_img, (batch_size,), generator=gen,
                                  device=dev),
        "pix_idxs": torch.randint(0, n_pix, (batch_size,), generator=gen,
                                  device=dev),
        "noise": torch.rand(batch_size, generator=gen, device=dev),
    }


class Trainer:
    """The state of one MoE training run on one device: parameters
    {model, gate} (updated in place), Adam, the density grids, the ray
    store and the generator of every draw (on the ray store's device)."""

    def __init__(self, cfg: MNGPConfig, tcfg: TrainConfig, params: dict,
                 gate_params: dict, model_state: dict, data: dict,
                 gen: torch.Generator):
        self.cfg, self.tcfg, self.gen = cfg, tcfg, gen
        self.rcfg = render_config(cfg, tcfg)
        self.buckets = budget_buckets(cfg.n_experts)
        self.bundle = {"model": params, "gate": gate_params}
        for p in tree_leaves(self.bundle):
            p.requires_grad_(True)
        self.model_state = model_state
        self.data = {**data, "mean_dir": data["directions"].mean(dim=0)}
        self.optimizer = torch.optim.Adam(
            tree_leaves(self.bundle), lr=lr_schedule(tcfg, 0), eps=1e-15)
        self.global_step = 0
        self.last_budget_util = None
        self._step = make_train_step(
            lambda b, s, batch, d: loss_fn(b, s, batch, d, self.cfg,
                                           self.rcfg, self.tcfg),
            self.optimizer, tcfg.n_microbatch,
        )

    def update_grid(self, warmup: bool) -> None:
        self.model_state = mngp_update_density_grids(
            self.bundle["model"], self.model_state, self.cfg, self.gen,
            DENSITY_THRESHOLD, warmup,
        )

    def train_step(self, batch: dict):
        """One Adam update at the scheduled learning rate (optax's count:
        the number of updates done before this one)."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr_schedule(self.tcfg, self.global_step)
        loss, aux = self._step(self.bundle, self.model_state, batch,
                               self.data)
        self.global_step += 1
        return loss, aux

    def maybe_adapt_budget(self) -> None:
        if self.last_budget_util is None:
            return
        new = next_budget_bucket(self.rcfg.budget_per_ray,
                                 self.last_budget_util, self.buckets)
        if new != self.rcfg.budget_per_ray:
            self.rcfg = dataclasses.replace(self.rcfg, budget_per_ray=new)

    def fit_steps(self, n_steps: int, on_step=None) -> None:
        """The inner loop of the reference's fit: a grid update every
        UPDATE_INTERVAL steps (all cells below warmup_steps), the
        adaptive budget at grid-update boundaries, a batch, a step.
        `on_step(step, loss, aux)` sees every step's (device) results."""
        for _ in range(n_steps):
            step = self.global_step
            if step % UPDATE_INTERVAL == 0:
                self.update_grid(warmup=step < self.tcfg.warmup_steps)
                if step >= self.tcfg.warmup_steps:
                    self.maybe_adapt_budget()
            batch = sample_batch(self.gen, self.data, self.tcfg.batch_size)
            loss, aux = self.train_step(batch)
            if step % UPDATE_INTERVAL == UPDATE_INTERVAL - 1:
                # one host read, right before the next grid update
                self.last_budget_util = float(aux["budget_util"])
            if on_step is not None:
                on_step(step, loss, aux)
