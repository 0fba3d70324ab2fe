"""Rad-NeRF training (twin of radnerf_tpu/train/trainer.py): the training
step and its loop (`Trainer`), and `NeRFSystem`, the shell of the entry
points (train_ml.py, train.py, oracle.py) around it: data, epochs,
validation, logging and checkpoints, on one device or on the ranks of a
data-parallel mesh (--num_devices, --multihost; parallel/).

The MoE step (--moe_training): gate, the experts' render
(ml_render_train: one union march and one shared hash encode by
default), per-expert MLPs and flat compositing, nerf_loss, backward,
Adam (eps 1e-15) at the cosine learning rate. Without --moe_training
the single NGP field (train.py's Instant-NGP baseline): render_train,
nerf_loss without the gate's terms, the same Adam. The hash family is
the config's `hash_impl` and `compute_dtype`. With --optimize_ext,
per-image pose corrections (axis-angle dR, translation dT) refine each
batch's cameras before its rays are cast, and take their own Adam group
at a constant 1e-8 with optax's eps 1e-8. Beside it the density grids
are updated every 16 steps (every cell below `warmup_steps`) and, with
--adaptive_budget (the default), the flat layout's sample budget is
re-picked from the measured buffer utilization (--layout dense has no
budget). Batches are drawn on the device from a
device-resident ray store; the per-ray start jitter is drawn from a
torch.Generator and travels in the batch.

On several ranks every rank draws the whole batch from its generator,
seeded alike on every rank, and keeps its own block: the generators stay
in lock-step, so the grid updates and the random backgrounds draw the
same numbers everywhere, and a ray's jitter does not depend on how the
batch is split. Each rank updates its grids from the same parameters and
draws. A warmup update sets every cell once, so the ranks' grids agree
bit for bit where their kernels and matrix products round alike (on the
CPU, at equal thread counts). Outside warmup a cell drawn twice keeps an
arbitrary one of its draws (the reference's scatter-set), so those
updates end with rank 0's grids broadcast.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
import re
import time

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..convert import (
    adam_state_from_jax, adam_state_to_jax, load_adam_state, params_to_jax,
    state_to_jax,
)
from ..data import dataset_dict
from ..data.color_utils import depth2img, imwrite
from ..losses import nerf_loss, total_loss
from ..metrics import psnr as psnr_fn
from ..metrics import ssim as ssim_fn
from ..models.gates import init_ray_gate
from ..models.mngp import (
    MNGPConfig, init_mngp, init_mngp_state, mngp_update_density_grids,
)
from ..models.ngp import (
    NGPConfig, init_ngp, init_ngp_state, update_density_grid,
)
from ..ops.hashgrid import hash_family, resolve_impl
from ..parallel.mesh import (
    Mesh, initialize_multihost, make_mesh, single_rank_mesh,
)
from ..parallel.step import (
    broadcast_from_main, make_train_step, shard_batch, tree_leaves,
)
from ..render.ml_render import get_rays, ml_render_train, render_rays_chunked
from ..render.render import (
    RenderConfig, render_test_compacted, render_train,
)
from ..utils.ckpt import (
    AsyncCkptWriter, load_ckpt, load_weights_into, save_ckpt, slim_ckpt,
)
from ..utils import trace
from ..utils.logging import MetricWriter, init_global_logger

MAX_SAMPLES = 1024
UPDATE_INTERVAL = 16
# flat-layout sample-budget buckets (--adaptive_budget)
BUDGET_BUCKETS = (16, 24, 32, 40, 48, 56, 64, 80, 96, 112)
DENSITY_THRESHOLD = 0.01 * MAX_SAMPLES / math.sqrt(3)
MICROBATCH_RAYS = 2048        # rays per accumulation slice (auto rule)
# --optimize_ext: the reference's constant extrinsics learning rate
# (train.py:160) and optax.adam's default eps (the network's is 1e-15)
EXT_LR, EXT_EPS = 1e-8, 1e-8


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
    """The bucket ladder, extended up to K x for the MoE union stream
    (n_experts 1: the single field's ladder)."""
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
    random_bg: bool = False          # a random background per expert
    adaptive_budget: bool = True     # re-pick the budget bucket
    layout: str = "flat"             # training samples: "flat" | "dense"


def n_microbatch(tcfg: TrainConfig, ranks: int = 1) -> int:
    """Accumulation slices of one rank's block of the batch, of
    batch_size // ranks rays (auto: one per MICROBATCH_RAYS rays of the
    block, as the reference counts them on the local batch)."""
    if tcfg.microbatch:
        return tcfg.microbatch
    return max(1, -(-(tcfg.batch_size // ranks) // MICROBATCH_RAYS))


def render_config(cfg: NGPConfig, tcfg: TrainConfig) -> RenderConfig:
    """The trainer's render settings: a constant-dt lattice and white
    background at scale <= 0.5 (else black, or random with random_bg),
    the training layout of tcfg (the test layout stays flat), and a union
    budget governed by the bucket ladder with the adaptive budget (factor
    1), else K x budget_per_ray (factor 0: auto-K, so quality never
    depends on a controller)."""
    return RenderConfig(
        exp_step_factor=1 / 256 if cfg.scale > 0.5 else 0.0,
        samples_per_ray=tcfg.samples_per_ray,
        random_bg=tcfg.random_bg,
        layout=tcfg.layout,
        budget_per_ray=tcfg.budget_per_ray,
        union_budget_factor=1.0 if tcfg.adaptive_budget else 0.0,
    )


def lr_schedule(tcfg: TrainConfig, step: int) -> float:
    """Cosine annealing per epoch from lr to lr / 30."""
    eta_min = tcfg.lr / 30
    epoch = min(step // tcfg.steps_per_epoch, tcfg.num_epochs)
    return eta_min + 0.5 * (tcfg.lr - eta_min) * (
        1 + math.cos(math.pi * epoch / tcfg.num_epochs))


def torch_axisangle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (N, 3) axis-angle -> (N, 3, 3) (twin of
    jnp_axisangle_to_R). Below theta^2 = 1e-8 the Taylor forms are taken,
    and both branches see safe inputs, so the gradient is finite at the
    all-zeros init."""
    t2 = (v * v).sum(dim=-1, keepdim=True)              # (N, 1)
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    zeros = torch.zeros_like(v[..., 0])
    K = torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)                                              # cross-product matrix
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def apply_pose_refinement(poses: torch.Tensor, ext: dict,
                          img_idxs: torch.Tensor) -> torch.Tensor:
    """(B, 3, 4) poses refined by their images' dR (axis-angle, applied on
    the left of the rotation) and dT (added to the centre)."""
    dR = torch_axisangle_to_R(ext["dR"][img_idxs])
    R = dR @ poses[..., :3]
    t = poses[..., 3] + ext["dT"][img_idxs]
    return torch.cat([R, t[..., None]], dim=-1)


def loss_fn(bundle: dict, model_state: dict, batch: dict, data: dict,
            cfg: NGPConfig, rcfg: RenderConfig, tcfg: TrainConfig,
            gen: torch.Generator | None = None):
    """(loss, aux) of a batch {img_idxs, pix_idxs, noise} over the ray
    store `data` {rays, poses, directions, mean_dir}; bundle {model,
    gate} (the MoE) or {model} (the single field) and, with
    --optimize_ext, "ext" {dR, dT}, which refines the batch's poses (the
    rays and the gate's image direction both see the refined poses);
    `gen` draws the random backgrounds (rcfg.random_bg).
    aux: psnr, rm_samples, budget_util."""
    poses = data["poses"][batch["img_idxs"]]
    if "ext" in bundle:
        poses = apply_pose_refinement(poses, bundle["ext"],
                                      batch["img_idxs"])
    rays_o, rays_d = get_rays(data["directions"][batch["pix_idxs"]], poses)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    target = {"rgb": data["rays"][batch["img_idxs"], batch["pix_idxs"]][:, :3]}
    weights = dict(lambda_opacity=tcfg.opacity_loss_w,
                   lambda_distortion=tcfg.distortion_loss_w)
    if "gate" in bundle:
        imgs_d = get_rays(data["mean_dir"].expand(poses.shape[0], 3),
                          poses)[1]
        out = ml_render_train(
            bundle["model"], model_state, cfg, bundle["gate"], rays_o,
            rays_d, imgs_d, rcfg, tcfg.gate_type, noise=batch["noise"],
            gen=gen,
        )
        weights.update(lambda_cv_importance=tcfg.cv_loss_w,
                       lambda_depth_mutual=tcfg.depth_mutual_loss_w)
    else:
        out = render_train(bundle["model"], model_state, cfg, rays_o, rays_d,
                           rcfg, noise=batch["noise"], gen=gen)
    with trace.span("loss"):
        ld = nerf_loss(out, target, **weights)
    aux = {
        "psnr": psnr_fn(out["rgb"], target["rgb"]),
        "rm_samples": out["rm_samples"].to(torch.float32),
        "budget_util": budget_util(out),
    }
    return total_loss(ld), aux


def budget_util(out: dict) -> torch.Tensor:
    """A render's budget_util, 0 where it measures none (the dense
    layout, the shared per-expert flat render)."""
    if "budget_util" in out:
        return out["budget_util"]
    return torch.zeros((), device=out["rgb"].device)


def sample_batch(gen: torch.Generator, data: dict, batch_size: int,
                 mesh: Mesh | None = None) -> dict:
    """Uniform (image, pixel) draws and the per-ray start jitter of the
    whole batch, on the ray store's device; with a mesh, this rank's
    block of it (shard_batch)."""
    dev = data["directions"].device
    n_img, n_pix = data["poses"].shape[0], data["directions"].shape[0]
    return shard_batch({
        "img_idxs": torch.randint(0, n_img, (batch_size,), generator=gen,
                                  device=dev),
        "pix_idxs": torch.randint(0, n_pix, (batch_size,), generator=gen,
                                  device=dev),
        "noise": torch.rand(batch_size, generator=gen, device=dev),
    }, mesh)


class Trainer:
    """The state of one rank of a training run: parameters {model,
    gate} (the MoE; gate_params None: {model}, the single field) and,
    with --optimize_ext, "ext" (updated in place), Adam, the density
    grids, the ray store and the generator of every draw (on the ray
    store's device).

    `loss(bundle, model_state, batch, data, cfg, rcfg, tcfg, gen) ->
    (loss, aux)` is the step's loss (default loss_fn); `density_fn(params,
    model_state, cfg) -> (x -> sigma)` the grid update's densities of one
    shared grid (default: the field's own, or each expert's with a gate).

    One torch.optim.Adam holds two parameter groups, as the reference's
    optax.multi_transform holds two Adams: group 0 the network {model[,
    gate]} (eps 1e-15, the cosine schedule), group 1 the pose corrections
    (EXT_LR, EXT_EPS, no schedule).

    `mesh` (default: one rank on the ray store's device) is the
    data-parallel mesh: each step takes this rank's block of the batch
    in n_microbatch(tcfg, mesh.size) slices and averages over the ranks
    (parallel.step). Every rank must start from the same parameters,
    grids and generator state."""

    def __init__(self, cfg: NGPConfig, tcfg: TrainConfig, params: dict,
                 gate_params: dict | None, model_state: dict, data: dict,
                 gen: torch.Generator, ext_params: dict | None = None,
                 loss=None, density_fn=None, mesh: Mesh | None = None):
        self.mesh = mesh or single_rank_mesh(data["directions"].device)
        if tcfg.batch_size % self.mesh.size:
            raise ValueError(f"batch {tcfg.batch_size} not divisible by "
                             f"{self.mesh.size} ranks")
        self.n_microbatch = n_microbatch(tcfg, self.mesh.size)
        self.cfg, self.tcfg, self.gen = cfg, tcfg, gen
        self.loss_fn = loss or loss_fn
        self.rcfg = render_config(cfg, tcfg)
        self.moe = gate_params is not None
        if density_fn is not None:
            self._update_grid = lambda p, s, *a: update_density_grid(
                p, s, *a, density_fn(p, s, cfg))
        else:
            self._update_grid = (mngp_update_density_grids if self.moe
                                 else update_density_grid)
        self.buckets = budget_buckets(cfg.n_experts if self.moe else 1)
        self.bundle = {"model": params}
        if self.moe:
            self.bundle["gate"] = gate_params
        groups = [{"params": tree_leaves(self.bundle)}]
        if ext_params is not None:
            self.bundle["ext"] = ext_params
            groups.append({"params": tree_leaves(ext_params), "lr": EXT_LR,
                           "eps": EXT_EPS})
        for p in tree_leaves(self.bundle):
            p.requires_grad_(True)
        self.model_state = model_state
        self.data = {**data, "mean_dir": data["directions"].mean(dim=0)}
        self.optimizer = torch.optim.Adam(groups, lr=lr_schedule(tcfg, 0),
                                          eps=1e-15)
        self.global_step = 0
        self.last_budget_util = None
        self._step = make_train_step(
            lambda b, s, batch, d: self.loss_fn(b, s, batch, d, self.cfg,
                                                self.rcfg, self.tcfg,
                                                self.gen),
            self.optimizer, self.n_microbatch, self.mesh,
        )

    def update_grid(self, warmup: bool) -> None:
        """Update the density grids (every cell with `warmup`). On several
        ranks an update outside warmup ends with rank 0's grids: a cell
        drawn twice keeps one of its draws, and which one is not fixed."""
        self.model_state = self._update_grid(
            self.bundle["model"], self.model_state, self.cfg, self.gen,
            DENSITY_THRESHOLD, warmup,
        )
        if not warmup:
            broadcast_from_main(tree_leaves(self.model_state), self.mesh)

    def train_step(self, batch: dict):
        """One Adam update, the network at the scheduled learning rate
        (optax's count: the number of updates done before this one)."""
        self.optimizer.param_groups[0]["lr"] = lr_schedule(
            self.tcfg, self.global_step)
        loss, aux = self._step(self.bundle, self.model_state, batch,
                               self.data)
        self.global_step += 1
        return loss, aux

    def maybe_adapt_budget(self) -> None:
        if self.last_budget_util is None or self.rcfg.layout != "flat":
            return
        new = next_budget_bucket(self.rcfg.budget_per_ray,
                                 self.last_budget_util, self.buckets)
        if new != self.rcfg.budget_per_ray:
            self.rcfg = dataclasses.replace(self.rcfg, budget_per_ray=new)

    def fit_steps(self, n_steps: int, on_step=None) -> None:
        """The inner loop of the reference's fit: a grid update every
        UPDATE_INTERVAL steps (all cells below warmup_steps), the
        adaptive budget at grid-update boundaries (with
        tcfg.adaptive_budget and the flat layout), a batch, a step.
        `on_step(step, loss, aux)` sees every step's (device) results,
        averaged over the ranks."""
        adaptive = self.tcfg.adaptive_budget and self.rcfg.layout == "flat"
        for _ in range(n_steps):
            step = self.global_step
            with trace.span("train.step"):
                if step % UPDATE_INTERVAL == 0:
                    with trace.span("train.grid_update"):
                        self.update_grid(warmup=step < self.tcfg.warmup_steps)
                    if adaptive and step >= self.tcfg.warmup_steps:
                        self.maybe_adapt_budget()
                with trace.span("train.batch"):
                    batch = sample_batch(self.gen, self.data,
                                         self.tcfg.batch_size, self.mesh)
                loss, aux = self.train_step(batch)
                if adaptive and step % UPDATE_INTERVAL == UPDATE_INTERVAL - 1:
                    # one host read, right before the next grid update
                    with trace.span("sync.budget_util"):
                        self.last_budget_util = float(aux["budget_util"])
            if on_step is not None:
                on_step(step, loss, aux)


class NeRFSystem:
    """The training system of the entry points (twin of radnerf_tpu's
    NeRFSystem) on `device`: the MoE with --moe_training (train_ml.py),
    else the single NGP field (train.py without it). It reads the scene
    from disk, keeps the ray store on the device, and drives a `Trainer`
    (which owns the step) through epochs with validation, logging and
    checkpoints. Logs, checkpoints and validation images go under
    logs/, ckpts/ and results/<dataset_name>/<scene_name>/<exp_name> in
    the working directory, as in the reference. With --ckpt_backend
    orbax the checkpoints are written by a background thread
    (utils.ckpt.AsyncCkptWriter).

    The system is one rank of the mesh that --num_devices (0: every
    local card) and --multihost give (parallel.make_mesh; --multihost
    first joins a launcher's group), on that rank's card (`device`
    "cuda": cuda:<local rank>). Every rank reads the scene and a
    checkpoint to resume; rank 0 alone validates and writes logs/,
    metrics, images, checkpoints and the slim export, while the others
    wait for it at the end of each epoch."""

    def __init__(self, hparams, device=DEFAULT_DEVICE):
        self.h = h = hparams
        if h.multihost:
            initialize_multihost(device=device)
        self.mesh = make_mesh(h.num_devices, device)
        self.device = self.mesh.device
        self.moe = bool(getattr(h, "moe_training", False))
        run = f"{h.dataset_name}/{h.scene_name}/{h.exp_name}"
        main = self.mesh.is_main
        self.logger = init_global_logger(f"logs/{run}/log.txt" if main
                                         else None)
        self.writer = MetricWriter(f"logs/{run}" if main else None)
        self.ckpt_dir = f"ckpts/{run}"
        self.val_dir = f"results/{run}"
        kw = dict(scale=h.scale, log2_T=h.hash_table_size,
                  compute_dtype=h.compute_dtype, hash_impl=h.hash_impl)
        self.cfg = (MNGPConfig(n_experts=h.model_zoo_size, **kw) if self.moe
                    else NGPConfig(**kw))
        self.ckpt_writer = (AsyncCkptWriter()
                             if h.ckpt_backend == "orbax" else None)
        self.trainer = None

    # ------------------------------------------------------------------
    def setup(self) -> None:
        h = self.h
        kwargs = {"root_dir": h.root_dir, "downsample": h.downsample,
                  "num_view": h.num_view}
        self.train_dataset = dataset_dict[h.dataset_type](
            split=h.split, **kwargs)
        self.test_dataset = dataset_dict[h.dataset_type](
            split="test", **kwargs)
        self.logger.info(
            f"train dataset: {len(self.train_dataset.poses)} images, "
            f"img_wh={self.train_dataset.img_wh}, images read by "
            f"{self.train_dataset.decoder}, device={self.device}")
        self.tcfg = self.train_config()
        mb = n_microbatch(self.tcfg, self.mesh.size)
        if mb > 1:
            self.logger.info(
                f"microbatch: batch {h.batch_size} on {self.mesh.size} "
                f"rank(s) -> {mb} accumulation slices a rank")
        self.configure_model()

    def train_config(self) -> TrainConfig:
        """The Trainer's options from the flags, on this mesh."""
        h = self.h
        return TrainConfig(
            lr=h.lr, num_epochs=h.num_epochs,
            steps_per_epoch=(h.steps_per_epoch
                             or self.train_dataset.STEPS_PER_EPOCH),
            batch_size=h.batch_size, microbatch=h.microbatch,
            warmup_steps=h.warmup_steps, samples_per_ray=h.samples_per_ray,
            budget_per_ray=h.budget_per_ray, gate_type=h.gate_type,
            opacity_loss_w=h.opacity_loss_w,
            distortion_loss_w=h.distortion_loss_w, cv_loss_w=h.cv_loss_w,
            depth_mutual_loss_w=h.depth_mutual_loss_w,
            random_bg=h.random_bg, adaptive_budget=h.adaptive_budget,
            layout=h.layout,
        )

    def init_model(self, gen: torch.Generator) -> tuple:
        """(params, gate params or None, model state) on the device, the
        weights drawn from `gen`."""
        dev = self.device
        if self.moe:
            return (init_mngp(gen, self.cfg, device=dev),
                    init_ray_gate(gen, self.cfg.n_experts, device=dev),
                    init_mngp_state(self.cfg, device=dev))
        return (init_ngp(gen, self.cfg, device=dev), None,
                init_ngp_state(self.cfg, device=dev))

    def trainer_hooks(self) -> dict:
        """The Trainer's `loss` and `density_fn` (none: its defaults)."""
        return {}

    def configure_model(self) -> None:
        """Weights from the seed (or --weight_path), empty grids, and the
        Trainer with its Adam and its draws' generator."""
        h, dev = self.h, self.device
        params, gate, state = self.init_model(
            torch.Generator().manual_seed(h.seed))
        if h.weight_path:
            params = load_weights_into(params, h.weight_path)
            self._reconcile_hash_impl(load_ckpt(h.weight_path))
            self.logger.info(f"warm-started weights from {h.weight_path}")
        ds = self.train_dataset

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        data = {"rays": put(ds.rays), "poses": put(ds.poses),
                "directions": put(ds.directions)}
        ext = None
        if h.optimize_ext:                    # train.py:146-150
            ext = {k: torch.zeros(len(ds.poses), 3, device=dev)
                   for k in ("dR", "dT")}
        self.trainer = Trainer(
            self.cfg, self.tcfg, params, gate, state, data,
            torch.Generator(device=dev).manual_seed(h.seed + 1), ext,
            mesh=self.mesh, **self.trainer_hooks())

    def lr_schedule(self, step: int) -> float:
        """The cosine schedule (train_ml.py:148-151) at `step`."""
        return lr_schedule(self.tcfg, step)

    @property
    def global_step(self) -> int:
        return self.trainer.global_step

    @property
    def params(self) -> dict:
        return self.trainer.bundle["model"]

    @property
    def gate_params(self) -> dict | None:
        return self.trainer.bundle.get("gate")

    @property
    def ext_params(self) -> dict | None:
        return self.trainer.bundle.get("ext")

    @property
    def model_state(self) -> dict:
        return self.trainer.model_state

    # ------------------------------------------------------------------
    def fit(self, on_step=None) -> None:
        """Train from the first incomplete epoch to --num_epochs: a
        validation every min(num_epochs, 10) epochs and at the last, a
        checkpoint per epoch, a log line and metrics every 100 steps,
        then the slim export (which waits for a checkpoint still being
        written); rank 0 alone validates and writes, and every rank
        waits for it at the end of each epoch. `on_step(step, loss, aux)`
        is called after every step. The rays/s are the whole batch's."""
        h = self.h
        spe = self.tcfg.steps_per_epoch
        check_every = min(h.num_epochs, 10)         # train_ml.py:296
        t_start = time.time()
        rays_done = 0
        prof = None

        def after_step(step, loss, aux):
            nonlocal rays_done, prof
            rays_done += h.batch_size
            if h.profile_steps and step == 9 and self.mesh.is_main:
                prof = self._start_profile()
            elif prof is not None and step == 9 + h.profile_steps:
                self._stop_profile(prof)
                prof = None
            if step % 100 == 0:
                loss_v, psnr_v = float(loss), float(aux["psnr"])
                rate = rays_done / (time.time() - t_start)
                self.writer.scalar("lr", self.lr_schedule(step), step)
                self.writer.scalar("train/loss", loss_v, step)
                self.writer.scalar("train/psnr", psnr_v, step)
                self.writer.scalar("train/rays_per_s", rate, step)
                self.logger.info(
                    f"epoch {step // spe} step {step}: loss={loss_v:.5f} "
                    f"psnr={psnr_v:.2f} rays/s={rate:,.0f}")
            if on_step is not None:
                on_step(step, loss, aux)

        for epoch in range(self.global_step // spe, h.num_epochs):
            self.trainer.fit_steps(spe, after_step)
            if (epoch + 1) % check_every == 0 or epoch == h.num_epochs - 1:
                self.validate(epoch)
            self.save_checkpoint(epoch)
            self.mesh.barrier()
        if prof is not None:
            self._stop_profile(prof)
        self.export_slim(h.num_epochs - 1)
        self.mesh.barrier()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self.logger.info(f"profiler trace of {self.h.profile_steps} steps "
                         f"from step 10")
        return prof

    def _stop_profile(self, prof) -> None:
        prof.stop()
        trace_dir = os.path.join(self.writer.logdir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace -> {path}")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, pose: torch.Tensor,
                    directions: torch.Tensor) -> dict:
        """Test-time render of camera-frame `directions` (P, 3) from
        `pose` (3, 4), in chunks of --val_chunk rays (render_rays_chunked):
        rgb (P, 3), depth (P,) (the MoE's gated consensus, or the single
        field's own), opacity (P,), total_samples. The single field on
        the dense test layout renders with alive-ray compaction between
        loop phases (render_test_compacted; `val_compaction` False on the
        options turns it off)."""
        rcfg = self.trainer.rcfg
        render = None
        if (not self.moe and rcfg.test_layout == "dense"
                and getattr(self.h, "val_compaction", True)):
            render = lambda ro, rd: render_test_compacted(
                self.params, self.model_state, self.cfg, ro, rd, rcfg)
        return render_rays_chunked(
            self.params, self.model_state, self.cfg, self.gate_params,
            directions, pose, rcfg, chunk=self.h.val_chunk,
            gate_type=self.h.gate_type,
            mean_dir=self.trainer.data["mean_dir"], render=render)

    def validate(self, epoch: int) -> dict:
        """Render every test camera; PSNR and SSIM (and LPIPS with
        --eval_lpips) against the ground truth where there is one, on the
        host; the prediction and its turbo depth as PNGs unless
        --no_save_test. Returns {"psnr", "ssim"} (None without ground
        truth, and on every rank but 0, which renders nothing)."""
        if not self.mesh.is_main:
            return {"psnr": None, "ssim": None}
        h, ds = self.h, self.test_dataset
        w, img_h = ds.img_wh
        directions = torch.from_numpy(ds.directions).to(self.device)
        save = not h.no_save_test
        if save:
            os.makedirs(self.val_dir, exist_ok=True)
        psnrs, ssims, lpipss = [], [], []
        for i, pose in enumerate(ds.poses):
            out = self.render_view(torch.from_numpy(pose).to(self.device),
                                   directions)
            rgb_pred = out["rgb"].cpu().reshape(img_h, w, 3)
            depth_pred = out["depth"].cpu().reshape(img_h, w).numpy()
            if len(ds.rays) > 0:
                rgb_gt = torch.from_numpy(ds.rays[i][:, :3]).reshape(
                    img_h, w, 3)
                psnrs.append(float(psnr_fn(rgb_pred, rgb_gt)))
                ssims.append(float(ssim_fn(rgb_pred, rgb_gt)))
                if h.eval_lpips:
                    from ..metrics import lpips_vgg

                    lpipss.append(lpips_vgg(rgb_pred, rgb_gt))
            if save:
                imwrite(os.path.join(self.val_dir, f"{i:03d}epoch{epoch}.png"),
                        (rgb_pred.numpy() * 255).astype(np.uint8))
                imwrite(
                    os.path.join(self.val_dir, f"{i:03d}epoch{epoch}_d.png"),
                    depth2img(depth_pred))
        if psnrs:
            step = self.global_step
            self.writer.scalar("test/psnr", np.mean(psnrs), step)
            self.writer.scalar("test/ssim", np.mean(ssims), step)
            self.logger.info(f"test/psnr={np.mean(psnrs)}")
            self.logger.info(f"test/ssim={np.mean(ssims)}")
            if lpipss:
                self.writer.scalar("test/lpips_vgg", np.mean(lpipss), step)
                self.logger.info(f"test/lpips={np.mean(lpipss)}")
        return {
            "psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None,
        }

    # ------------------------------------------------------------------
    def latest_checkpoints(self) -> list:
        """Full checkpoints in this experiment's ckpt dir, newest epoch
        first (slim exports excluded: they drop the optimizer state)."""
        found = []
        for p in glob.glob(os.path.join(self.ckpt_dir, "epoch=*.ckpt")):
            m = re.match(r"epoch=(\d+)\.ckpt$", os.path.basename(p))
            if m:
                found.append((int(m.group(1)), p))
        return [p for _, p in sorted(found, reverse=True)]

    def auto_resume(self) -> bool:
        """--resume auto: continue from the newest loadable checkpoint in
        the experiment dir; a file that does not load (a torn write) is
        skipped with a warning. False (a fresh start) when none loads."""
        for path in self.latest_checkpoints():
            try:
                self.resume(path)
                return True
            except Exception as e:  # a torn or foreign file: try the next
                self.logger.warning(
                    f"auto-resume: could not load {path} ({e!r}); "
                    "trying the previous checkpoint")
        self.logger.info(
            f"auto-resume: no usable checkpoint under {self.ckpt_dir}; "
            "starting fresh")
        return False

    def resume(self, ckpt_path: str) -> None:
        """Full resume (params, pose corrections, Adam state, grids, step)
        from a checkpoint of either package. An Adam state that does not
        match the parameters (another optimizer layout) is dropped:
        training goes on with fresh Adam moments, as in the reference."""
        ckpt = load_ckpt(ckpt_path)
        tr = self.trainer
        _copy_into(tr.bundle["model"], ckpt["params"], "params")
        if "gate" in tr.bundle and "gate_params" in ckpt:
            _copy_into(tr.bundle["gate"], ckpt["gate_params"], "gate_params")
        if "ext" in tr.bundle and "ext_params" in ckpt:
            _copy_into(tr.bundle["ext"], ckpt["ext_params"], "ext_params")
        tr.optimizer.state.clear()
        if "opt_state" in ckpt:
            try:
                load_adam_state(tr.optimizer, tr.bundle,
                                adam_state_from_jax(ckpt["opt_state"]))
            except ValueError as e:
                self.logger.info(f"resume: opt_state structure mismatch "
                                 f"({e}) — starting with fresh optimizer "
                                 "state")
        if "model_state" in ckpt:
            _copy_into(tr.model_state, ckpt["model_state"], "model_state")
        tr.global_step = int(ckpt.get("step", 0))
        self._reconcile_hash_impl(ckpt)
        self.logger.info(f"resumed from {ckpt_path} at step "
                         f"{self.global_step}")

    def _reconcile_hash_impl(self, ckpt: dict) -> None:
        """Route encode_dispatch to the hash family that TRAINED the
        restored table (checkpoints record the resolved impl; a family
        mismatch would decode garbage)."""
        rec = (ckpt.get("hparams") or {}).get("resolved_hash_impl")
        if rec is None:
            return
        rec = str(rec)
        if hash_family(rec) == hash_family(self.cfg.hash_impl):
            return
        if (hash_family(rec) in ("slab", "brick", "brick3")
                and self.cfg.cdtype != torch.bfloat16):
            raise ValueError(
                f"checkpoint was trained with the {hash_family(rec)} hash"
                f" family ({rec}), which only supports --compute_dtype"
                " bfloat16; refusing to decode it with"
                f" compute_dtype={self.cfg.compute_dtype}")
        self.logger.info(
            f"checkpoint hash family '{hash_family(rec)}' ({rec}) != "
            f"session family '{hash_family(self.cfg.hash_impl)}' — "
            f"switching hash_impl to '{rec}' to match the trained table")
        self.cfg = dataclasses.replace(self.cfg, hash_impl=rec)
        if self.trainer is not None:
            self.trainer.cfg = self.cfg

    def save_checkpoint(self, epoch: int) -> None:
        """epoch=<epoch>.ckpt in the JAX package's layout, recording the
        RESOLVED hash impl (a table decodes only under its family); the
        MoE's gate_params, and with --optimize_ext ext_params. With
        --ckpt_backend orbax the file is written in the background (the
        values are copied to the host first). Rank 0 alone writes."""
        if not self.mesh.is_main:
            return
        hp = dict(vars(self.h))
        hp["resolved_hash_impl"] = resolve_impl(self.cfg.hash_impl)
        params, gate = params_to_jax(self.params, self.gate_params)
        payload = {
            "params": params,
            "opt_state": adam_state_to_jax(self.trainer.optimizer,
                                           self.trainer.bundle),
            "model_state": state_to_jax(self.model_state),
            "step": self.global_step,
            "hparams": hp,
        }
        if gate is not None:
            payload["gate_params"] = gate
        if self.ext_params is not None:
            payload["ext_params"] = state_to_jax(self.ext_params)
        path = os.path.join(self.ckpt_dir, f"epoch={epoch}.ckpt")
        if self.ckpt_writer is not None:
            self.ckpt_writer.save(path, payload)
        else:
            save_ckpt(path, payload)

    def wait_for_checkpoint(self) -> None:
        """Return once no checkpoint is being written (re-raising the
        background write's error, if it failed)."""
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait()

    def export_slim(self, epoch: int) -> None:
        """The slim file of the last checkpoint, as the reference writes
        it: slim_ckpt keeps "pose_params", which no checkpoint holds (the
        poses are saved as "ext_params"), so no slim file carries poses.
        Rank 0 alone writes."""
        if not self.mesh.is_main:
            return
        self.wait_for_checkpoint()
        path = os.path.join(self.ckpt_dir, f"epoch={epoch}.ckpt")
        if os.path.exists(path):
            save_ckpt(os.path.join(self.ckpt_dir, f"epoch={epoch}_slim.ckpt"),
                      slim_ckpt(path, save_poses=self.h.optimize_ext))
        self.export_video()

    def export_video(self) -> None:
        """Stitch the last epoch's validation frames into rgb.mp4 /
        depth.mp4 for synthetic NSVF scenes (train.py:331-340); skipped,
        with a log line, where imageio or its ffmpeg backend is
        missing."""
        h = self.h
        if (h.no_save_test or h.dataset_type != "nsvf"
                or "Synthetic" not in str(h.root_dir)):
            return
        try:
            import imageio.v2 as imageio
        except ImportError:
            self.logger.info("video export skipped (imageio is not "
                             "installed)")
            return
        imgs = sorted(glob.glob(os.path.join(
            self.val_dir, f"*epoch{h.num_epochs - 1}*.png"))) or sorted(
            glob.glob(os.path.join(self.val_dir, "*.png")))
        if not imgs:
            return
        for name, frames in (("rgb.mp4", imgs[::2]),
                             ("depth.mp4", imgs[1::2])):
            try:
                imageio.mimsave(os.path.join(self.val_dir, name),
                                [imageio.imread(p) for p in frames],
                                fps=30, macro_block_size=1)
            except (ValueError, OSError) as e:  # no ffmpeg backend etc.
                self.logger.info(f"video export skipped ({e})")
                return
        self.logger.info(f"saved rgb.mp4/depth.mp4 to {self.val_dir}")

    def close(self) -> None:
        """Wait for a checkpoint still being written, then close the
        metric writer."""
        try:
            self.wait_for_checkpoint()
        finally:
            self.writer.close()


@torch.no_grad()
def _copy_into(dst, src, what: str) -> None:
    """Copy the numpy tree `src` into the tensor tree `dst` in place
    (ValueError, before any copy, where their leaves differ in number or
    shape)."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s) or any(tuple(a.shape) != tuple(np.shape(b))
                               for a, b in zip(d, s)):
        raise ValueError(f"checkpoint {what} do not match the model's")
    for a, b in zip(d, s):
        a.copy_(torch.from_numpy(np.array(b)).to(a.dtype))
