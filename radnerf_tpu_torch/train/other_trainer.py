"""The training system of the multi-submodel baselines, `--model_type
{switch, block, mega}` (twin of radnerf_tpu/train/other_trainer.py):

- switch: the point-gated shared field (models/switch.py), the gate
  trained end to end, the cv loss on its load;
- block / mega: the shared field with K rgb heads under a spatial gate:
  k-means over the training cameras' centres gives K anchors, and a
  ray's gate is the softmax of its origin's negative squared distances
  to them over --overlap_ratio (near 0: one-hot).

It is NeRFSystem with its own model, loss, grid-update densities and
validation render; the anchors are not checkpointed, but computed again
from the cameras on every start, resume included, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..losses import nerf_loss, total_loss
from ..metrics import psnr as psnr_fn
from ..models.block import (
    BlockNGPConfig, block_density, init_block_ngp, init_block_ngp_state,
)
from ..models.ngp import pack_table
from ..models.switch import (
    SwitchNGPConfig, init_switch_ngp, init_switch_ngp_state, switch_density,
)
from ..render.block_render import block_render_test, block_render_train
from ..render.ml_render import get_rays, render_rays_chunked
from ..render.switch_render import switch_render_test, switch_render_train
from .trainer import NeRFSystem, budget_util


def kmeans_cameras(positions: np.ndarray, k: int, iters: int = 50,
                   seed: int = 0) -> np.ndarray:
    """Tiny k-means over camera centres -> (k, 3) submodel anchors."""
    rng = np.random.default_rng(seed)
    centers = positions[rng.choice(len(positions), k, replace=False)]
    for _ in range(iters):
        d = ((positions[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            pts = positions[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return centers


def spatial_gating(rays_o: torch.Tensor, anchors: torch.Tensor,
                   overlap_ratio: float) -> torch.Tensor:
    """(N, K) gate: softmax over the anchors of -|o - anchor|^2 /
    max(overlap_ratio, 1e-6), on the rays' device."""
    anchors = anchors.to(rays_o.device)
    d2 = ((rays_o[:, None, :] - anchors[None]) ** 2).sum(dim=-1)
    return torch.softmax(-d2 / max(float(overlap_ratio), 1e-6), dim=1)


def other_loss_fn(kind: str, anchors: torch.Tensor | None,
                  overlap_ratio: float):
    """The Trainer's loss for `kind`: (bundle, model_state, batch, data,
    cfg, rcfg, tcfg, gen) -> (loss, aux {psnr, rm_samples, budget_util}).
    The batch's "noise" is the start jitter; for switch an optional
    "gate_noise" (N, budget_per_ray, K) on the flat layout or (N,
    samples_per_ray, K) on the dense one is the gate's noise of each
    ray's slots (else drawn from `gen`). nerf_loss with the opacity term, and
    for switch the cv term on the gate's load. Pose corrections
    (--optimize_ext) are not applied, as in the reference's loss."""

    def loss(bundle, model_state, batch, data, cfg, rcfg, tcfg, gen=None):
        poses = data["poses"][batch["img_idxs"]]
        rays_o, rays_d = get_rays(data["directions"][batch["pix_idxs"]],
                                  poses)
        rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
        target = {"rgb": data["rays"][batch["img_idxs"],
                                      batch["pix_idxs"]][:, :3]}
        params = bundle["model"]
        if kind == "switch":
            gate_noise = batch.get("gate_noise")
            if gate_noise is not None:
                gate_noise = gate_noise.reshape(-1, cfg.n_experts)
            out = switch_render_train(
                params, model_state, cfg, rays_o, rays_d, rcfg,
                noise=batch["noise"], gate_noise=gate_noise, gen=gen)
            out["gating_importance"] = out["gating_importance"].to(
                torch.float32)
            ld = nerf_loss(out, target, lambda_opacity=tcfg.opacity_loss_w,
                           lambda_cv_importance=tcfg.cv_loss_w)
        else:
            out = block_render_train(
                params, model_state, cfg, rays_o, rays_d,
                spatial_gating(rays_o, anchors, overlap_ratio), rcfg,
                noise=batch["noise"], gen=gen)
            ld = nerf_loss(out, target, lambda_opacity=tcfg.opacity_loss_w)
        aux = {
            "psnr": psnr_fn(out["rgb"], target["rgb"]),
            "rm_samples": out["rm_samples"].to(torch.float32),
            "budget_util": budget_util(out),
        }
        return total_loss(ld), aux

    return loss


def other_density_fn(kind: str):
    """The grid update's densities: the switch field through its clean
    gate, or the shared block density, on a table packed once per
    update, through cfg.hash_impl."""

    def density_fn(params, model_state, cfg):
        packed = pack_table(params["hash_table"], cfg)
        if kind == "switch":
            return lambda x: switch_density(params, model_state, cfg, x,
                                            packed=packed)
        return lambda x: block_density(params, model_state, cfg, x,
                                       packed=packed)

    return density_fn


class OtherNeRFSystem(NeRFSystem):
    """`--model_type {switch, block, mega}` on `device` (mega is block).
    --moe_training is forced off. The config takes --scale,
    --hash_table_size, --model_zoo_size and --compute_dtype; --hash_impl
    is not read ('auto' applies), as in the reference."""

    def __init__(self, hparams, device=DEFAULT_DEVICE):
        hparams.moe_training = False
        super().__init__(hparams, device=device)
        self.kind = hparams.model_type
        config = SwitchNGPConfig if self.kind == "switch" else BlockNGPConfig
        self.cfg = config(scale=hparams.scale,
                          log2_T=hparams.hash_table_size,
                          n_experts=hparams.model_zoo_size,
                          compute_dtype=hparams.compute_dtype)
        self.anchors = None

    def init_model(self, gen: torch.Generator) -> tuple:
        """The switch or block field and its one grid; for block / mega
        the anchors from the training cameras."""
        dev = self.device
        if self.kind == "switch":
            return (init_switch_ngp(gen, self.cfg, device=dev), None,
                    init_switch_ngp_state(self.cfg, device=dev))
        cams = np.asarray(self.train_dataset.poses[..., 3])
        self.anchors = torch.from_numpy(
            kmeans_cameras(cams.copy(), self.cfg.n_experts)).to(dev)
        return (init_block_ngp(gen, self.cfg, device=dev), None,
                init_block_ngp_state(self.cfg, device=dev))

    def trainer_hooks(self) -> dict:
        return {"loss": other_loss_fn(self.kind, self.anchors,
                                      self.h.overlap_ratio),
                "density_fn": other_density_fn(self.kind)}

    def render_chunk(self, rays_o: torch.Tensor,
                     rays_d: torch.Tensor) -> dict:
        """The test-time render of one chunk of rays."""
        rcfg = self.trainer.rcfg
        if self.kind == "switch":
            return switch_render_test(self.params, self.model_state,
                                      self.cfg, rays_o, rays_d, rcfg)
        return block_render_test(
            self.params, self.model_state, self.cfg, rays_o, rays_d,
            spatial_gating(rays_o, self.anchors, self.h.overlap_ratio), rcfg)

    @torch.no_grad()
    def render_view(self, pose: torch.Tensor,
                    directions: torch.Tensor) -> dict:
        return render_rays_chunked(
            self.params, self.model_state, self.cfg, None, directions, pose,
            self.trainer.rcfg, chunk=self.h.val_chunk,
            render=self.render_chunk)
