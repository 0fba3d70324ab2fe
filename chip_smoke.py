#!/usr/bin/env python3
"""Drive the PyTorch port's Rad-NeRF MoE render and training, its
examples' microbenchmark kernels, its train_ml.py entry point on a scene
on disk, every dataset loader of the launch scripts, train.py's single
NGP field, the per-expert and unshared MoE renders, train_other.py's
Switch-, Block- and Mega-NeRF baselines, and the dense sample layout, on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught error and a nonzero exit; there is no
CPU fallback):
  1. device: the card's name and power limit, from nvidia-smi;
  2. build: compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels 1 and 2 vs their plain PyTorch versions on the card, at the
     shapes of the render's first loop iteration on a 4096-ray chunk: the
     candidate occupancy on 4096 x 512 candidates (must be equal), the
     brick3 encode on the iteration's 98,304 marched samples at L=16,
     T=2^19 (within one bf16 ulp, reading the packed table and reading the
     f32 table); median times of kernel, plain version and library call,
     and the device time of the training step's call (the f32 table);
  4. the slice at full width: MNGP zoo=2 (scale 0.5, T=2^19, G=128, bf16,
     brick3) from torch.Generator seed 0, expert 0 occupying a solid
     0.3-radius sphere and expert 1 its +x half, renders a 400x400 pinhole
     image from radius 1.2 through render_rays_chunked (chunk 4096,
     RenderConfig 128 / 24 / 512), timed three times (median rays/s);
     launch counts are reset just before the first render and read just
     after it; one chunk is profiled (device busy share, top
     kernels); then one 256-ray chunk is rendered again on the card and on
     the CPU (plain versions) and compared;
  5. training at full width (zoo=2, T=2^19, L=16, G=128, bf16, brick3;
     batch 8192 in 4 microbatches of 2048 rays, budget 64, lr 1e-2, cv
     1e-2, depth-mutual 5e-3) on an analytic emissive 0.3-sphere: a ray
     store of 32 cameras x 64x64 pixels whose target colours the port's
     own march and compositor render (no dataset); then every kernel
     against its plain version at one 2048-ray microbatch's shapes (the
     union march's 2048 x 1024 lattice candidates, its marched samples,
     the table gradient of a random output gradient; the tcnn, slab and
     brick scatter kernels on the streams their families' backwards build
     from the same samples and gradient), with each kernel's and library
     call's device time alone (a CUDA graph of 20 calls), the PyTorch
     forwards of the other families timed on the same samples, the
     brick3, tcnn, slab and brick table gradients on six streams made for
     their warp aggregation, and the encode on one warmup grid update's
     2,097,152 cells; then TRAIN_STEPS steps of
     Trainer.fit_steps (grid updates every 16 steps, every cell below
     step 256, the adaptive budget), launch counts reset just before and
     read just after; loss and PSNR at intervals, train rays/s (median
     over the steps after the first 16); the microbatch checks again at
     the trained grids and the grown budget; one step profiled; the
     encode alone timed (forward and backward) at a trained microbatch;
     then one 256-ray step on the card and on the CPU (plain versions)
     from the same parameters and draws, loss and every gradient leaf
     compared (each leaf printed with its worst entry), the ray gate's
     output layer at its term scale on the card's forward;
  6. the 'dedup' family (the tcnn hash, whose backward is the
     tcnn_table_grad kernel) trained the same way from the same seeds for
     DEDUP_STEPS steps: PSNR must rise, the launch counts are exact
     (tcnn_table_grad once per microbatch, no brick3 kernel); one step
     profiled; the encode alone timed; 256-ray card-vs-CPU steps on seed 3
     and PIN_SEEDS, each leaf held against the CPU step that takes the
     card's forward once the two forwards are found equal up to their
     bf16 roundings (TRAIN_CPU_GRAD_RTOL); and one float32 step
     (compute_dtype float32, hash_impl brick3, which routes to 'dedup')
     card against CPU;
  7. short runs of the 'slab', 'brick' and 'pallas' families
     (FAMILY_STEPS steps each): finite losses, exact launch counts of
     their kernels, the encode alone timed, and a 256-ray card-vs-CPU
     step each;
  8. the examples' kernels: bench_vmem_gather and proto_pallas_gather
     run at their default sizes (4,194,304 words from a (4096, 128) table;
     2^20 rows gathered from and added into a (2^19, 2) table), and
     bench_vmem_gather again on a (WIDE_ROWS, 128) table, too large for
     tal_sublane to stage, so that its wrapper launches tal_sublane_l2;
     launch counts reset just before and read just after; then each of
     their five kernels against its plain twin at those sizes (the four
     gathers bit-equal, also on their script's edge draw, `with_edges`;
     the scatter within its f32 order bound), median
     times of kernel, twin and library call, and the device time of
     kernel and library call without host gaps (CUDA graphs); then
     profile_step at its defaults (the dedup step split into its
     parts);
  9. the entry point, as a user runs it: a Tanks-and-Temples-layout NSVF
     scene (4x4 intrinsics.txt at 1920x1080, bbox.txt, pose/*.txt) of
     phase 5's emissive sphere, 48 training and 4 test views at
     downsample 0.1 (192x108), written as PNGs by the port's codec into
     a temporary directory (which also holds the run's logs/, ckpts/
     and results/), read back by the loader (the decoder is printed);
     the untrained system validated once; then
     radnerf_tpu_torch.train_ml.main with rad_TAT.sh's ZOO=2 options
     (T=2^19, batch 8192, lr 1e-2, cv 1e-2, depth-mutual 5e-3, brick3)
     for ENTRY_EPOCHS epochs of ENTRY_STEPS steps (cut from 20 x 1000):
     two full checkpoints, a slim one, validation PNGs, metrics.jsonl,
     and a test PSNR 3 dB above the untrained one; main again with one
     more epoch and --resume auto, which must resume at step 256 and
     write epoch=2.ckpt; radnerf_tpu_torch.oracle.main renders the test
     split from it, within 1e-3 dB of that validation; then one 256-ray
     chunk of a test view from the checkpoint on the card and on the CPU
     (plain versions), within phase 4's tolerance. Launch counts are
     reset just before the untrained system and read after the CPU
     chunk (brick3_table_grad exactly 4 per step); the phase's seconds,
     median train rays/s and the nvidia-smi line are printed;
 10. the datasets of the launch scripts, read back from scenes of phase
     5's emissive sphere that the phase writes with the port's own codecs
     into a temporary directory, each in its loader's layout, at the
     model's full width (MNGP zoo=2, T=2^19, L=16, G=128, bf16, brick3),
     batch 8192: three full runs through train_ml.main with their
     scripts' options, DS_EPOCHS epochs of 64 or 96 steps (cut from 20 x
     1000), each validated untrained and after training (test PSNR up by
     more than 3 dB) and checkpointed: `nerfpp` (rad_tat.sh's M60 line,
     scale 4, PNGs whose size the header gives, with --optimize_ext: the
     pose corrections finite, nonzero and in the checkpoint) and `eyeful`
     (rad_eyeful.sh's, scale 4; JPEGs at --downsample 0.25 instead of 1,
     resized up 1.5x), both of phase 9's scene scaled 8x to the scale-4
     box, cameras outside it; `scannet` (rad_scannet.sh's, scale 0.5; a
     half-size sphere seen from cameras inside the box, JPEGs with a
     24-pixel border, one pose inf, at --downsample 0.25 instead of 0.5,
     written at two thirds of the training size and resized up); then
     four short runs of DS_SHORT_STEPS steps and one validation (finite
     losses): `nerf` (RGBA PNGs at 200x200, --downsample 0.25), `rtmv`
     (a 'bricks' box, 108 frames at 48x48), `replica` and `mill19` (JPEGs
     at 64x48; .pt metadata written with torch.save). --eval_lpips is
     left out (no torchmetrics on the card's machine). Printed: why the
     native decoder did not load or build, the host times of one
     1296x968 4:2:0 JPEG decode and one 1248x920 -> 648x484
     resize_linear, each loader's decoder, views and PSNRs, the full
     runs' median train rays/s, the phase's launch counts (reset before
     its first scene, read after its last run; brick3_table_grad exactly
     4 per step), its seconds and the nvidia-smi line;
 11. the single field and the expert renders: (a) train.py's entry point
     (radnerf_tpu_torch.train.main without --moe_training) with
     base_TAT.sh's options (T=2^19, batch 8192, lr 1e-2, auto = brick3,
     bf16) on phase 9's scene with phase 9's cuts: the untrained field
     validated, ENTRY_EPOCHS epochs of ENTRY_STEPS steps (test PSNR up
     by more than 3 dB, checkpoints without a gate), one more epoch
     resumed with --resume auto and --ckpt_backend orbax (its checkpoint
     written in the background must load, at the right step), the oracle
     without --moe_training within 1e-3 dB of that validation; launch
     counts reset before and read after (brick3_table_grad exactly 4 per
     step; kernels 1 and 2 launched); (b) the single field card vs CPU:
     a CHUNK-ray render_test chunk of test view 0 (CPU_TOL), and one
     step-0 microbatch of 2048 rays of a fresh field on phase 5's ray
     store (TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GRAD_RTOL), one step of it
     profiled; (c) the MoE at zoo=2 and full width on phase 5's ray store
     with rad_TAT.sh's ZOO=2 options, EXPERT_STEPS steps each of the
     shared table without union sampling (each expert its own march, one
     encode of both sample sets) and of unshared_MNGP (two f32 (16, 2^19,
     2) tables, 128 MiB): losses finite, training PSNR up by more than
     3 dB, exact launch counts (brick3_table_grad 4 per step shared, 8
     unshared), one step profiled, a 256-ray card-vs-CPU step and a
     256-ray ml_render_test chunk card vs CPU; (d) the port's
     examples/smoke_e2e.py at its defaults (its own check: PSNR up by
     more than 5 dB; tcnn_table_grad once per step). Printed: the median
     train rays/s, each part's seconds and the nvidia-smi line;
 12. train_other.py's baselines on phase 9's scene with phase 9's cuts,
     at full width (zoo 2, T=2^19, L=16, G=128, bf16, auto = brick3,
     batch 8192, scale 0.5): (a) switch with switch_tat.sh's options
     (the point gate, cv 1e-4) through radnerf_tpu_torch.train_other.main:
     the untrained system validated, ENTRY_EPOCHS epochs of ENTRY_STEPS
     steps (test PSNR up by more than 3 dB, checkpoints without a gate
     recording brick3), one more epoch with --resume auto from step
     2 x ENTRY_STEPS; launch counts reset before and read after
     (brick3_table_grad exactly 4 per step; kernels 1 and 2 launched);
     then card vs CPU: a CHUNK-ray test chunk of test view 0 from the
     resumed system (CPU_TOL) and one step-0 microbatch of 2048 rays of
     a fresh model on phase 5's ray store (TRAIN_CPU_LOSS_RTOL,
     TRAIN_CPU_GRAD_RTOL), its gate noise drawn on the CPU for both
     sides; the CPU side routes the point gate as the card did
     (RouteTap): the flipped top-1 slots are counted, each must be a
     near tie and they at most 0.1% of the slots; one step profiled;
     (b) block with block_TAT.sh's options (--downsample cut to 0.1) the
     same way, its anchors printed, validated untrained, after training
     and after the resumed epoch; (c) mega for DS_SHORT_STEPS steps and
     one validation (finite losses, brick3_table_grad 4 per step).
     Printed: each part's seconds, the median train rays/s and the
     nvidia-smi line;
 13. the dense layout (--layout dense, samples_per_ray 192) at full
     width: (a) kernels 1-3 against their plain versions at a dense
     step-0 microbatch of a fresh MoE trainer (kernel 2 on each expert's
     own 2048 x 1024 candidates and grid, kernels 1 and 3 on the 2 x 2048
     x 192 = 786,432 slots, pad slots included), DENSE_FIT_STEPS dense
     steps of it, one step profiled,
     with the peak device memory, and one 256-ray dense step card vs CPU
     (phase 5's tolerances, the gate's output layer at its term scale);
     (b) train_ml.main with rad_TAT.sh's ZOO=2 options and --layout dense
     on phase 9's scene, the untrained system validated, DENSE_EPOCHS
     epochs of DENSE_STEPS steps (test PSNR up by more than 3 dB,
     brick3_table_grad exactly 4 per step; launch counts reset before and
     read after: `launches_by_path.dense`), its median train rays/s and
     peak memory; (c) phase 4's field (expert 0 alone) on the dense test
     layout: render_test and render_test_compacted over the 400x400 image
     (rays/s) and one CHUNK-ray chunk of each card vs CPU (CPU_TOL); (d)
     DS_SHORT_STEPS steps each of switch and block through
     train_other.main --layout dense with one validation (finite losses,
     `launches_by_path.dense_baselines`). Printed: the phase's seconds
     and the nvidia-smi line;
 14. a JSON line with every kernel's check, launches (per phase), times
     and bound;
 15. the last line: {"ok": true, "device": {...}}.

Phase 4 also renders 256 rays with hash_impl 'dedup' on the card and on
the CPU (no brick3 table is packed for it, and no brick3 kernel runs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import struct
import subprocess
import tempfile
import time
import zlib

import numpy as np
import torch

import radnerf_tpu_torch.models.gates as gates_mod
import radnerf_tpu_torch.render.ml_render as ml_render_mod
from radnerf_tpu_torch import kernels, oracle, train_ml, train_other
from radnerf_tpu_torch.data import native, png
from radnerf_tpu_torch.data.color_utils import resize_linear
from radnerf_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, write_jpeg
from radnerf_tpu_torch.data.png import write_png
from radnerf_tpu_torch.data.ray_utils import get_ray_directions
from radnerf_tpu_torch.examples import bench_vmem_gather as tvg
from radnerf_tpu_torch.examples import profile_step
from radnerf_tpu_torch.examples import proto_pallas_gather as tpg
from radnerf_tpu_torch.examples import smoke_e2e
from radnerf_tpu_torch.models.block import BlockNGPConfig, init_block_ngp
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mlp import layer_tap, slice_stacked
from radnerf_tpu_torch.models.mngp import (
    MNGPConfig, expert_forward_fn, init_mngp, init_mngp_state,
    pack_for_encode,
)
from radnerf_tpu_torch.models.ngp import (
    NGPConfig, all_cell_coords, cell_world_positions, init_ngp,
    init_ngp_state, scene_center_half,
)
from radnerf_tpu_torch.models.switch import SwitchNGPConfig, init_switch_ngp
from radnerf_tpu_torch.ops import hashgrid_brick, hashgrid_slab
from radnerf_tpu_torch.ops.compositing import composite_train_flat
from radnerf_tpu_torch.ops.fma import fma32
from radnerf_tpu_torch.ops.hashgrid import (
    encode_dispatch, hashgrid_encode, hashgrid_indices, hashgrid_indices_cm,
)
from radnerf_tpu_torch.ops.hashgrid_brick3 import (
    _corner_terms, _encode_plain, _table_grad_plain,
    hashgrid_encode_brick3_fwd_impl, hashgrid_table_grad_brick3,
    pack_brick3_table,
)
from radnerf_tpu_torch.ops.hashgrid_dedup import (
    hashgrid_encode_dedup_fwd_impl,
)
from radnerf_tpu_torch.ops.hashgrid_pallas import (
    hashgrid_table_grad, point_stream,
)
from radnerf_tpu_torch.ops.hashgrid_window import (
    hashgrid_table_grad_window, tcnn_stream,
)
from radnerf_tpu_torch.ops.intersection import scene_near_far
from radnerf_tpu_torch.ops.marching import (
    _lattice_candidates, _occ_flat_index, calc_dt, march_rays_test_flat,
    march_rays_train, march_rays_union_flat, occupancy_lookup,
    occupancy_lookup_bricks, sample_lattice,
)
from radnerf_tpu_torch.ops.stream_table_grad import (
    stream_table_grad, stream_table_grad_plain, stream_terms,
)
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves, tree_paths, tree_unflatten,
)
from radnerf_tpu_torch.render.ml_render import get_rays, render_rays_chunked
from radnerf_tpu_torch.opt import get_opts
from radnerf_tpu_torch.render.render import (
    NEAR_DISTANCE, RenderConfig, render_test, render_test_compacted,
)
from radnerf_tpu_torch.render.block_render import block_render_test
from radnerf_tpu_torch.render.switch_render import switch_render_test
from radnerf_tpu_torch.train import trainer as tt
from radnerf_tpu_torch.train.other_trainer import (
    OtherNeRFSystem, kmeans_cameras, other_density_fn, other_loss_fn,
    spatial_gating,
)
from radnerf_tpu_torch.utils.ckpt import load_ckpt

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32, outside the tensor cores
T_START = time.perf_counter()
SIDE = 400                      # image side (pixels)
CHUNK = 4096                    # rays per ml_render_test call (--val_chunk)
CPU_RAYS = 256                  # rays of the card-vs-CPU chunk
RENDER_REPEATS = 3              # timed full renders (median reported)
# card vs CPU on the same 256 rays: the MLPs run in bf16, and cuBLAS and
# the CPU sum in different orders, so an MLP output may differ by one bf16
# ulp: rgb (a bf16 sigmoid, ulp 2^-8 on [0.5, 1)) by ~4e-3 per ulp, sigma
# = exp(bf16) by a relative 2^-8 at most; the march and the encode are
# exact (phase 3), so nothing else moves.
CPU_TOL = {"rgb": 1e-2, "opacity": 5e-3, "depth": 5e-3}
TRAIN_STEPS = 320               # 256 warmup steps, then 4 later updates
STORE_IMAGES, STORE_SIDE = 32, 64   # the ray store: 32 cameras x 64x64
# card vs CPU, one 256-ray training step: the rays, the march and the
# encode are exact on both (phase 3; render/ml_render.py::get_rays), the
# table gradient is the same f32 sum in another (atomic) order; the bf16
# MLPs (cuBLAS vs the CPU) may round an output one bf16 ulp apart (2^-8
# relative), which the backward carries into every leaf: the loss within
# 1%, each gradient leaf within 2% of its largest entry.
# The dedup check (pin_forward): a bf16 layer output h = bf16(bf16(mm) + b)
# of the two sides, from the same inputs, is two roundings of sums of the
# same K products in two orders, each within K 2^-23 sum|terms| of the
# exact sum (a truncating tensor-core adder included): |h_card - h_cpu|
# <= ulp(mm) + ulp(h) + 2 K 2^-23 (|x| @ |w|). The MLPs' inputs are the
# rays, the encode (both exact) and the SH encode of the unit ray
# directions, whose norm sums three squares in two orders (the CPU's
# vector_norm fuses them): each unit component within 6 f32 ulps, and a
# basis polynomial (degree <= 3, coefficients <= 2.9) within ~81 2^-24,
# under 2^-16, before its cast to bf16: |x_card - x_cpu| <= ulp(x) +
# 2^-16. One such step in a density
# logit moves sigma = exp(h) by up to 6% (ulp(h) = 2^-4 on [8, 16)), and
# the compositor carries that to the ray's later samples and every leaf,
# beyond any bound on the leaves; so, once every layer output is found
# within that bound (and the encode features equal), the card's step is
# held against the CPU step that takes the card's forward values. What
# is left is the backward's: each bf16 gradient one rounding apart, one
# bf16 ulp of a leaf entry being at most 2^-7 of the leaf's largest, so
# 2% holds 2.5 of them. Except where the leaf cancels: the ray gate's
# output layer (gate/encoder/b/4 read 0.0533 of its largest entry on an
# H100). Its softmax makes each logit's gradient a difference, p_k (g_k -
# p.g), which training drives towards zero as the experts agree, and
# which each side casts to bf16 from f32 values far closer than a bf16
# ulp: each term one rounding apart at most, 2^-7 of itself. The layer's
# leaves sum these terms over the rays (the weight: times the layer's
# input, the same on both sides) in f32, in two orders (2 K 2^-24 of
# the sum of magnitudes, K = CPU_RAYS), and round the entry once more to
# bf16 (2^-7 of it): |diff| <= (2^-6 + 2 K 2^-24) sum|terms| < 0.016
# sum|terms|, while the entries themselves cancel to 1.1-772x below it
# (H100 runs). So the output layer's two leaves are held at 2% of their
# largest sum of term magnitudes, |x|^T |dL/dlogits| (bias: sum
# |dL/dlogits|); the inner gate layers, never seen beyond 0.0071 of
# their largest entry on an H100, are held at it like every other leaf,
# which also catches a halved gate gradient (checked on every batch).
TRAIN_CPU_LOSS_RTOL = 1e-2
TRAIN_CPU_GRAD_RTOL = 2e-2
# the same in float32: the MLPs' f32 sums in other orders (cuBLAS vs the
# CPU); the first geo layer's weight gradient sums tiny hash features
# with much cancellation, so its leaf moves most
TRAIN_CPU_F32_LOSS_RTOL = 1e-4
TRAIN_CPU_F32_GRAD_RTOL = 5e-3
DEDUP_STEPS = 320               # the dedup family: as long as phase 5
# samples of each aggregation stream: a step-0 microbatch's slots
AGG_SAMPLES = 2048 * 64
# the dedup card-vs-CPU check: further 256-ray batches of the trained
# state, held beside seed 3 (TRAIN_CPU_GRAD_RTOL)
PIN_SEEDS = tuple(range(10, 58))
FAMILY_STEPS = 48               # slab, brick, pallas: 3 warmup updates
WIDE_ROWS = 8192                # phase 8: a table above the staged limit
# hash family -> its table-gradient kernel
# phase 9, the entry point: a Tanks-and-Temples-layout NSVF scene of the
# emissive sphere (48 training and 4 test views at downsample 0.1 of
# 1920x1080), trained by train_ml with rad_TAT.sh's ZOO=2 options for
# ENTRY_EPOCHS epochs of ENTRY_STEPS steps, then resumed for one more
ENTRY_VIEWS, ENTRY_TEST_EVERY = 52, 13     # views 6, 19, 32, 45: test
ENTRY_FOCAL = 1500.0                       # pixels at 1920x1080
ENTRY_EPOCHS, ENTRY_STEPS = 2, 128
ENTRY_ARGS = ("--dataset_type", "nsvf", "--dataset_name", "TanksAndTemple",
              "--scene_name", "Sphere", "--downsample", "0.1",
              "--scale", "0.5", "--model_zoo_size", "2", "--gate_type",
              "ray", "--batch_size", "8192", "--lr", "1e-2",
              "--cv_loss_w", "1e-2", "--depth_mutual_loss_w", "5e-3",
              "--hash_impl", "brick3", "--hash_table_size", "19",
              "--steps_per_epoch", str(ENTRY_STEPS))
# phase 10, the datasets of the launch scripts: the sphere's scenes in
# each loader's layout; three full runs of DS_EPOCHS epochs (cut from 20
# x 1000 steps; DS_FULL has each run's steps an epoch) and four short runs
# of DS_SHORT_STEPS steps
DS_CFG = {0.5: MNGPConfig(scale=0.5), 4.0: MNGPConfig(scale=4.0)}
# at scale 4 the sphere and its cameras are phase 9's scaled to the box
# (4 / 0.5): the unscaled sphere in the large box, its cameras inside or
# outside it, left the test PSNR flat in 128-256 steps on an H100 (each
# training view painted where only its own rays pass)
BOX_SIZE = 8.0
DS_VIEWS = 27                   # every 9th a test view: 24 train, 3 test
DS_SCANNET, DS_EYEFUL = 0.25, 0.25       # --downsample (scripts: 0.5, 1)
SCANNET_VIEWS, SCANNET_INF = 33, 5       # one pose inf: 30 train, 2 test
DS_EPOCHS, DS_SHORT_STEPS = 2, 16
# phase 11, the single field and the expert renders: base_TAT.sh's options
# (train.py without --moe_training) on phase 9's scene, with phase 9's
# cuts; then the per-expert and unshared MoE renders trained EXPERT_STEPS
# steps each on phase 5's ray store; then smoke_e2e at its defaults
SINGLE_ARGS = ("--dataset_type", "nsvf", "--dataset_name", "TanksAndTemple",
               "--scene_name", "Sphere", "--downsample", "0.1",
               "--scale", "0.5", "--batch_size", "8192", "--lr", "1e-2",
               "--hash_table_size", "19", "--steps_per_epoch",
               str(ENTRY_STEPS))
# 48 steps left unshared_MNGP's training PSNR 2.54 dB up (the per-expert
# render 3.44; this phase at 48 steps on an H100): each table learns from
# its own expert's gated gradient only; 64 steps
EXPERT_STEPS = 64
SMOKE_STEPS = 300                # examples/smoke_e2e.py's default
# phase 12, train_other.py's baselines on phase 9's scene with phase 9's
# cuts: switch_tat.sh's and block_TAT.sh's options (--downsample cut to
# phase 9's 0.1; --eval_lpips left out, as in phase 10), and --model_type
# mega for DS_SHORT_STEPS steps
BASELINE_ARGS = {
    "switch": ("--model_type", "switch", "--model_zoo_size", "2",
               "--gate_type", "point", "--cv_loss_w", "1e-4"),
    "block": ("--model_type", "block", "--model_zoo_size", "2"),
    "mega": ("--model_type", "mega", "--model_zoo_size", "2"),
}
# phase 13, the dense layout: rad_TAT.sh ZOO=2's options with --layout
# dense (samples_per_ray 192: every ray's 192 slots encoded, pad slots
# included), the MoE entry point DENSE_EPOCHS epochs of DENSE_STEPS steps
# on phase 9's scene, and DS_SHORT_STEPS steps each of switch and block
DENSE_EPOCHS, DENSE_STEPS = 2, 64
DENSE_FIT_STEPS = 32             # the trainer's steps before its CPU step
DENSE_ARGS = ("--layout", "dense", "--steps_per_epoch", str(DENSE_STEPS))
FAMILY_KERNELS = {"brick3": "brick3_table_grad",
                  "dedup": "tcnn_table_grad", "slab": "slab_table_grad",
                  "brick": "brick_table_grad", "pallas": "tcnn_table_grad"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over `reps` launches of fn, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(n_bytes: float, n_ops: float) -> dict:
    """Least time the card could take: the larger of bytes over HBM rate
    and float32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |x|, elementwise, in float32."""
    x = x.float().abs()
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the bf16 ulp of max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, bf16_ulp(mag), 1.0)
    return float(((a - b).abs() / ulp).max())


def camera(side: int, device):
    """bench_render's pinhole camera at radius 1.2 looking at the origin:
    camera-frame directions (u, v, 1.2) and the (3, 4) camera-to-world."""
    eye = np.array([0.0, -1.2, 0.25])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    u, v = np.meshgrid((np.arange(side) + 0.5) / side - 0.5,
                       (np.arange(side) + 0.5) / side - 0.5)
    dirs = np.stack([u, v, np.full_like(u, 1.2)], -1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pose = np.concatenate(
        [np.stack([right, down, fwd], axis=1), eye[:, None]], axis=1)
    return (torch.tensor(dirs, dtype=torch.float32, device=device),
            torch.tensor(pose, dtype=torch.float32, device=device))


def occupancy(cfg: MNGPConfig, device) -> torch.Tensor:
    """Expert 0: bench_render's solid 0.3-radius sphere; expert 1: its +x
    half, so that membership masking is exercised."""
    g = cfg.grid_size
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = (np.sqrt(xx**2 + yy**2 + zz**2) * cfg.scale) < 0.3
    occ = np.stack([sphere, sphere & (xx > 0)])[:, None]
    return torch.tensor(np.broadcast_to(
        occ, (2, cfg.cascades, g, g, g)).copy(), device=device)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def brick3_words_needed(x: torch.Tensor, cfg) -> int:
    """Distinct packed-table words the encode of x must read (a packed
    word and a table entry share one flat index)."""
    return int(torch.unique(_corner_terms(x, cfg)[0]).numel())


def profile_call(render, label: str = f"one {CHUNK}-ray chunk") -> dict:
    """Where one call's time goes: wall time, summed device kernel time
    (kernels run on one stream, so the sum is the busy time), launch
    count, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    if not by_name:
        print("[profile] device time: not measured (no CUDA events)")
        return {}
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{launches} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "kernels": launches}


def shell_poses(n_img: int, radius: float = 1.2) -> np.ndarray:
    """(n_img, 3, 4) camera-to-world poses on a shell of `radius` (a
    Fibonacci spiral), each looking at the origin."""
    i = np.arange(n_img) + 0.5
    z = 1.0 - 2.0 * i / n_img
    phi = np.pi * (1.0 + 5.0**0.5) * i
    eyes = radius * np.stack([np.sqrt(1 - z * z) * np.cos(phi),
                           np.sqrt(1 - z * z) * np.sin(phi), z], axis=1)
    poses = []
    for eye in eyes:
        fwd = -eye / np.linalg.norm(eye)
        up = [0.0, 0.0, 1.0] if abs(fwd[2]) < 0.9 else [1.0, 0.0, 0.0]
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses.append(np.concatenate(
            [np.stack([right, down, fwd], axis=1), eye[:, None]], axis=1))
    return np.stack(poses)


def sphere_store(n_img: int, side: int, device) -> dict:
    """The ray store of the training phase: shell_poses(n_img), each
    camera looking through the same side x side pinhole directions."""
    u, v = np.meshgrid((np.arange(side) + 0.5) / side - 0.5,
                       (np.arange(side) + 0.5) / side - 0.5)
    dirs = np.stack([u, v, np.full_like(u, 1.2)], -1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return {
        "poses": torch.tensor(shell_poses(n_img), dtype=torch.float32,
                              device=device),
        "directions": torch.tensor(dirs, dtype=torch.float32, device=device),
    }


@torch.no_grad()
def render_sphere(store: dict, cfg: MNGPConfig, chunk: int = 4096,
                  background: float = 1.0, size: float = 1.0):
    """Target colours of every ray of the store: examples/smoke_e2e.py's
    emissive sphere (sigma 40 inside radius 0.3, colour (0.5 + x, 0.5 + y,
    0.5 - z) clipped), scaled by `size` (radius 0.3 size, sigma 40 / size,
    colour of x / size), rendered by the port's union march (a grid of the
    sphere's cells in every cascade of cfg.scale, jitter 0.5) and
    training compositor, on a `background` grey level (white by default).
    Returns (n_img, n_pix, 3)."""
    dev = store["directions"].device
    g = cfg.grid_size
    lin = (torch.arange(g, device=dev) + 0.5) / g * 2 - 1
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    r = (xx**2 + yy**2 + zz**2).sqrt()
    # cascade c spans [-s, s], s = min(2^(c-1), scale): a cell is occupied
    # where the sphere may reach it
    occ = torch.stack([
        r * s < max(0.32 * size, 0.3 * size + 3**0.5 * s / g)
        for s in (min(2.0 ** (c - 1), cfg.scale)
                  for c in range(cfg.cascades))])[None]
    # the trainer's lattice: constant steps up to scale 0.5, else growing
    # with t (render_config), so that far cameras reach the sphere
    mcfg = RenderConfig(samples_per_ray=512, exp_step_factor=(
        1 / 256 if cfg.scale > 0.5 else 0.0)).march(cfg)
    n_img, n_pix = store["poses"].shape[0], store["directions"].shape[0]
    out = []
    for img in range(n_img):
        for c0 in range(0, n_pix, chunk):
            rays_o, rays_d = get_rays(store["directions"][c0:c0 + chunk],
                                      store["poses"][img])
            rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
            t1, t2 = scene_near_far(rays_o, rays_d, torch.zeros(3, device=dev),
                                    torch.full((3,), cfg.scale, device=dev),
                                    NEAR_DISTANCE)
            m, member = march_rays_union_flat(
                rays_o, rays_d, t1, t2, occ, mcfg, torch.full_like(t1, 0.5),
                budget_per_ray=256)
            check(int(m["total"]) < m["ts"].shape[0],
                  "target render truncated rays")
            rid = m["ray_id"].long()
            x = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid]) / size
            sigma = torch.where(x.norm(dim=1) < 0.3, 40.0 / size, 0.0)
            color = torch.stack([0.5 + x[:, 0], 0.5 + x[:, 1],
                                 0.5 - x[:, 2]], 1).clamp(0, 1)
            res = composite_train_flat(sigma, color, m["deltas"], m["ts"],
                                       m["ray_id"], m["offsets"], m["cap"],
                                       member[0])
            out.append(res["rgb"]
                       + background * (1.0 - res["opacity"][:, None]))
    return torch.cat(out).reshape(n_img, n_pix, 3)


def render_scene(dev) -> dict:
    """Phase 4's model: MNGP zoo=2 at full width (scale 0.5, T=2^19,
    G=128, bf16, brick3) from torch.Generator seed 0, expert 0 occupying a
    solid 0.3-radius sphere and expert 1 its +x half, and the 400x400
    camera."""
    cfg = MNGPConfig(scale=0.5, log2_T=19, grid_size=128, n_experts=2,
                     compute_dtype="bfloat16", hash_impl="brick3")
    gen = torch.Generator().manual_seed(0)
    params = init_mngp(gen, cfg, device=dev)
    gate = init_ray_gate(gen, cfg.n_experts, device=dev)
    state = {**init_mngp_state(cfg, device=dev),
             "occ": occupancy(cfg, dev)}
    directions, pose = camera(SIDE, dev)
    return {"cfg": cfg, "rcfg": RenderConfig(), "params": params,
            "gate": gate, "state": state, "directions": directions,
            "pose": pose}


def render_iteration(scene: dict) -> dict:
    """The first loop iteration of the render's middle chunk (from ray
    c0): its lattice candidates (xyz, dt) against the union grid, and its
    marched samples xn in [0, 1]^3, n_valid of them valid."""
    cfg, rcfg, state = scene["cfg"], scene["rcfg"], scene["state"]
    mcfg = rcfg.march(cfg)
    dev = scene["directions"].device
    c0 = (scene["directions"].shape[0] // CHUNK // 2) * CHUNK
    rays_o, rays_d = get_rays(scene["directions"][c0:c0 + CHUNK],
                              scene["pose"])
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    occ_union = state["occ"].any(dim=0).contiguous()
    k = torch.arange(rcfg.test_k_block, device=dev, dtype=torch.int32)
    t = sample_lattice(t1[:, None], k[None, :], mcfg)
    dt = calc_dt(t, mcfg)
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])
    m = march_rays_test_flat(
        rays_o, rays_d, t1, t2, occ_union, mcfg, t1 >= 0,
        k_block=rcfg.test_k_block, cap_per_ray=rcfg.test_block_samples,
        budget_per_ray=rcfg.test_budget_per_ray,
    )
    rid = m["ray_id"].long()
    xs = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((xs - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    return {"c0": c0, "xyz": xyz, "dt": dt, "occ_union": occ_union,
            "mcfg": mcfg, "xn": xn, "n_valid": int(m["total"])}


def encode_check(table, packed, xn, hcfg, at: str, n_valid: int,
                 plain_reps: int = 50) -> dict:
    """Kernel 1 against its plain version on positions xn (within one
    bf16 ulp), reading the packed words and reading the f32 table, with
    the times of both, the plain version's and the bounds. `ms`,
    `device_ms` and `bound_ms` are those of the packed read (`form`: the
    render's and the grid update's call, which pack once beforehand,
    `pack_device_ms`); `train_path_device_ms` and `train_path_bound_ms`
    those of the call as the training step makes it, on the f32 table
    with no pack."""
    enc_a = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg, packed=packed)
    enc_b = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg)
    enc_p = _encode_plain(packed, xn, hcfg)
    torch.cuda.synchronize()
    check(torch.equal(_encode_plain(table, xn, hcfg), enc_p),
          f"brick3 plain encode of the f32 table != of the packed words at "
          f"{at}")
    ulps = {form: bf16_ulps(enc, enc_p)
            for form, enc in (("packed", enc_a), ("f32", enc_b))}
    for form, u in ulps.items():
        check(u <= 1.0, f"brick3_encode_fwd kernel ({form} table) vs plain "
                        f"at {at}: {u} ulp")
    n, L = xn.shape[0], hcfg.n_levels
    rec = {
        "at": at, "check": "<= 1 bf16 ulp (packed and f32 table)",
        "form": "packed bf16x2 words (render, grid update)",
        "max_abs_err": max(float((enc.float() - enc_p.float()).abs().max())
                           for enc in (enc_a, enc_b)),
        "max_ulp": max(ulps.values()),
        "exact_share": float((enc_a == enc_p).float().mean()),
        "exact_share_f32": float((enc_b == enc_p).float().mean()),
        "shape": f"{n} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}",
        "ms": median_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "device_ms": graph_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "train_path_device_ms": graph_ms(
            lambda: hashgrid_encode_brick3_fwd_impl(table, xn, hcfg)),
        "pack_device_ms": graph_ms(lambda: pack_brick3_table(table)),
        "plain_ms": median_ms(lambda: _encode_plain(packed, xn, hcfg),
                              reps=plain_reps, warmup=min(5, plain_reps)),
        "library_ms": None, "library_device_ms": None,
        "library_call": "none: no PyTorch call computes a hash-grid encode",
    }
    # x in, 2 bf16 out per (sample, level), the distinct table entries
    # read: 4-byte words packed, 8-byte f32 pairs on the training path;
    # ~60 f32 operations per (sample, level) (3 fma-floor-sub, 8 weights,
    # 16 multiply-adds)
    io, ops = n * 12 + n * L * 4, n * L * 60
    entries = brick3_words_needed(xn, hcfg)
    rec.update(bound(io + entries * 4, ops))
    rec["train_path_bound_ms"] = bound(io + entries * 8, ops)["bound_ms"]
    return rec


def occ_check(xyz, dt, occ_union, mcfg, at: str) -> dict:
    """Kernel 2 against its plain version on candidates (xyz, dt) (must be
    equal), with the times of both, of one indexing call, and the bound."""
    occ_k = occupancy_lookup_bricks(xyz, dt, occ_union, mcfg)
    occ_p = occupancy_lookup(xyz, dt, occ_union, mcfg)
    torch.cuda.synchronize()
    check(torch.equal(occ_k, occ_p), f"occ_lookup kernel != plain version "
                                     f"at {at}")
    flat = _occ_flat_index(xyz, dt, mcfg)
    occ_flat = occ_union.reshape(-1)
    n_cand = dt.numel()
    rec = {
        "at": at, "check": "exact",
        "max_abs_err": float((occ_k.float() - occ_p.float()).abs().max()),
        "shape": f"{tuple(dt.shape)} candidates, {tuple(occ_union.shape)} "
                 f"grid, {int(occ_k.sum())} occupied",
        "ms": median_ms(lambda: occupancy_lookup_bricks(xyz, dt, occ_union,
                                                        mcfg)),
        "device_ms": graph_ms(lambda: occupancy_lookup_bricks(
            xyz, dt, occ_union, mcfg)),
        "plain_ms": median_ms(lambda: occupancy_lookup(xyz, dt, occ_union,
                                                       mcfg)),
        # the advanced-indexing gather of occupancy_lookup, given the flat
        # cell indices: not a yardstick for the same function (no PyTorch
        # call computes the lookup from positions)
        "library_ms": median_ms(lambda: occ_flat[flat]),
        "library_device_ms": graph_ms(lambda: occ_flat[flat]),
        "library_call": "a gather of precomputed cell indices (less work)",
    }
    # xyz, dt in and a bool out per candidate, one byte per distinct cell;
    # ~24 f32 operations per candidate (abs/max, frexp, 3 x div-add-mul-
    # mul-clamp)
    rec.update(bound(n_cand * (12 + 4 + 1) + int(torch.unique(flat).numel()),
                     n_cand * 24))
    return rec


def brick3_grad_err(xn, g, hcfg, got) -> tuple:
    """|got - the plain twin| of kernel 3 on (xn, g) and its summation-order
    bound: the same f32 products summed by atomics in an order that
    changes from run to run, within 2 (n - 1) u sum|terms| per table entry
    (n terms, u = 2^-24). Returns (err, tol), each (L * T, 2)."""
    dev = xn.device
    L, T = hcfg.n_levels, hcfg.table_size
    ref = _table_grad_plain(xn, g, hcfg)
    idx, w = _corner_terms(xn, hcfg)
    vals = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None])
    flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1, 2)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat_idx, flat_vals.abs())
    count = torch.zeros(L * T, device=dev).index_add_(
        0, flat_idx, (flat_vals[:, 0] != 0).float())
    tol = 2 * (count[:, None] - 1).clamp_min(1) * 2.0**-24 * abs_sum
    return (got - ref).abs().reshape(-1, 2), tol


def stream_grad_err(name, keys, vals, T: int, got) -> tuple:
    """|got - the plain twin| of a stream kernel and its summation-order
    bound, 2 (n - 1) u sum|terms| per table entry. Returns (err, tol, the
    stream's terms)."""
    dev = keys.device
    L = keys.shape[0]
    ref = stream_table_grad_plain(name, keys, vals, T)
    flat, terms = stream_terms(name, keys, vals, T)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat, terms.abs())
    count = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat, (terms != 0).float())
    tol = 2 * (count - 1).clamp_min(1) * 2.0**-24 * abs_sum
    return (got - ref).abs().reshape(-1, 2), tol, terms


ORDER_CHECK = ("within 2 (n - 1) 2^-24 sum|terms| per entry (atomic "
               "summation order)")


def table_grad_check(xn, g, hcfg, at: str, n_valid: int) -> dict:
    """Kernel 3 against its plain version (within its summation-order
    bound), with the times of both, of one index_add_ call and of the
    output's zero-fill alone, the wrapper's and the index_add_'s device
    time alone, and the bound."""
    dev = xn.device
    L, T = hcfg.n_levels, hcfg.table_size
    err, tol = brick3_grad_err(xn, g, hcfg,
                               hashgrid_table_grad_brick3(xn, g, hcfg))
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"brick3_table_grad kernel vs plain at "
                                    f"{at}: max|diff| {float(err.max())}")
    idx, w = _corner_terms(xn, hcfg)
    vals = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None])
    flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1, 2)

    def library():
        return torch.zeros((L * T, 2), device=dev).index_add_(
            0, flat_idx, flat_vals)

    rec = {
        "at": at, "check": ORDER_CHECK,
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"{xn.shape[0]} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}, out {L * T * 8 >> 20} MiB",
        "ms": median_ms(lambda: hashgrid_table_grad_brick3(xn, g, hcfg)),
        "device_ms": graph_ms(lambda: hashgrid_table_grad_brick3(xn, g,
                                                                 hcfg)),
        "plain_ms": median_ms(lambda: _table_grad_plain(xn, g, hcfg)),
        # one PyTorch call for the same scatter-add, given the flat corner
        # indices and products (the zero-fill included, as in the kernel)
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
        "library_call": "index_add_ of precomputed corner indices and "
                        "products, zero-fill included (less work)",
        # the wrapper's torch.zeros of the output, alone
        "zero_fill_ms": median_ms(lambda: torch.zeros((L, T, 2),
                                                      device=dev)),
    }
    # x and g read once, the 64 MiB gradient written once; ~60 f32
    # operations per valid (sample, level): 3 fma-floor-sub, 8 weights,
    # 16 products, 16 adds
    rec.update(bound(xn.shape[0] * (12 + 8 * L) + L * T * 8,
                     n_valid * L * 60))
    return rec


def stream_check(name: str, contract: str, keys, vals, T: int, at: str,
                 contract_fn) -> dict:
    """A scatter kernel of csrc/stream_table_grad.cu against its plain
    twin on the stream its family's backward builds (within the atomic
    summation-order bound), with the times of the kernel's wrapper, the
    twin, one index_add_ of the same terms and the whole contract
    function (the stream built from positions and gradient included), the
    wrapper's and the index_add_'s device time alone, and the bound."""
    dev = keys.device
    L, n = keys.shape
    err, tol, terms = stream_grad_err(name, keys, vals, T,
                                      stream_table_grad(name, keys, vals, T))
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"{name} kernel vs plain ({contract}) "
                                    f"at {at}: max|diff| {float(err.max())}")
    flat, _ = stream_terms(name, keys, vals, T)
    n_terms = int((terms != 0).sum())

    def library():
        return torch.zeros((L * T, 2), device=dev).index_add_(0, flat, terms)

    rec = {
        "at": at, "contract": contract, "check": ORDER_CHECK,
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"{L} x {n} stream entries, {n_terms} nonzero f32 terms, "
                 f"T=2^{T.bit_length() - 1}, out {L * T * 8 >> 20} MiB",
        "ms": median_ms(lambda: stream_table_grad(name, keys, vals, T)),
        "device_ms": graph_ms(lambda: stream_table_grad(name, keys, vals,
                                                        T)),
        "plain_ms": median_ms(lambda: stream_table_grad_plain(
            name, keys, vals, T), reps=10),
        # one PyTorch call for the same scatter-add, given the flat
        # entries and terms (the zero-fill included, as in the kernel)
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
        "library_call": "index_add_ of the precomputed flat entries and "
                        "terms, zero-fill included (less work)",
        "contract_ms": median_ms(contract_fn, reps=10),
    }
    # keys and value planes read once, the 64 MiB gradient written once;
    # one f32 add per nonzero term
    rec.update(bound(keys.numel() * 4 + vals.numel() * 4 + L * T * 8,
                     n_terms))
    return rec


def stream_checks(xn, g, hcfg, at: str) -> dict:
    """Kernels 4-7 (three CUDA entry points) at one microbatch: the tcnn
    stream of the corner-major and the point-major corners, the slab pair
    stream and the brick stream of positions xn and output gradient g.
    Returns {contract: check record}."""
    T = hcfg.table_size
    recs = {}
    idx, w = hashgrid_indices_cm(xn, hcfg)
    recs["hashgrid_table_grad_window"] = stream_check(
        "tcnn_table_grad", "hashgrid_table_grad_window",
        *tcnn_stream(idx, w, g), T, at,
        lambda: hashgrid_table_grad_window(idx, w, g, hcfg))
    idx, w = hashgrid_indices(xn, hcfg)
    recs["hashgrid_table_grad"] = stream_check(
        "tcnn_table_grad", "hashgrid_table_grad", *point_stream(idx, w, g),
        T, at, lambda: hashgrid_table_grad(idx, w, g, hcfg))
    del idx, w
    recs["sorted_table_grad_window_pair"] = stream_check(
        "slab_table_grad", "sorted_table_grad_window_pair",
        *slab_stream(xn, g, hcfg), T, at,
        lambda: hashgrid_slab.hashgrid_table_grad_slab(xn, g, hcfg))
    recs["sorted_table_grad_brick"] = stream_check(
        "brick_table_grad", "sorted_table_grad_brick",
        *brick_stream(xn, g, hcfg), T, at,
        lambda: hashgrid_brick.hashgrid_table_grad_brick(xn, g, hcfg))
    return recs


def slab_stream(xn, g, hcfg) -> tuple:
    """The slab backward's pair stream of xn and g as slab_table_grad
    takes it: keys (L, n) and the planes (f0, f1 at k; f0, f1 at k + 1)."""
    key, (v0e, v0o, v1e, v1o) = hashgrid_slab._bwd_streams(xn, g, hcfg)
    return key, torch.stack([v0e, v1e, v0o, v1o])


def brick_stream(xn, g, hcfg) -> tuple:
    """The brick backward's stream of xn and g as brick_table_grad takes
    it: keys (L, n) and 8 planes."""
    key, vals = hashgrid_brick._bwd_streams(xn, g, hcfg)
    return key, torch.stack(vals)


def aggregation_inputs(n: int, L: int, dev) -> dict:
    """Positions in [0, 1]^3 and output gradients (N, 2L) made for the warp
    aggregation of the table-gradient kernels (torch.Generator seed 9):
    every sample in one cell with positive gradients (every warp one
    group; each entry's terms of one sign, so its order bound is 2 (n - 1)
    2^-24 of the entry itself, and a group sum that left out lanes would
    fail it); samples spread uniformly (hardly any group); runs of 8
    samples on one point with every third sample's gradient zero (groups
    with zero-gradient members); rays of 64 samples 2^-10 apart, cut to a
    length that is a multiple neither of the kernels' 64-sample tile nor
    of 32 (nor of the slab stream's 128); and single samples, 1 and 33,
    spread uniformly."""
    gen = torch.Generator(device=dev).manual_seed(9)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    g = torch.randn((n, 2 * L), generator=gen, device=dev)
    k = torch.arange(n, device=dev)
    n_rays = -(-n // 64)
    d = torch.randn((n_rays, 3), generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    o = 0.25 + 0.5 * u(n_rays, 3)
    ray = (o[k // 64] + d[k // 64] * ((k % 64)[:, None] * 2.0**-10)
           ).clamp(0.0, 1.0)
    m = n - 13
    return {
        "one cell, positive gradients": (u(1, 3).expand(n, 3).contiguous(),
                                         g.abs()),
        "uniform": (u(n, 3), g),
        "runs of 8, zero-gradient members": (
            u(-(-n // 8), 3)[k // 8].contiguous(),
            torch.where((k % 3 == 0)[:, None], 0.0, g).contiguous()),
        f"rays, ragged length {m}": (ray[:m].contiguous(),
                                     g[:m].contiguous()),
        **{f"uniform, n = {k}": (u(k, 3), g[:k].contiguous())
           for k in (1, 33)},
    }


def aggregation_checks(hcfg, n: int, dev) -> dict:
    """brick3_table_grad and the stream kernels (tcnn on the dedup path's
    corner-major stream, slab and brick on the streams their backwards
    build) against their plain twins, under the same summation-order
    bound, on each stream of aggregation_inputs. Returns {kernel row key:
    [check records]}."""
    T = hcfg.table_size

    def stream_err(name, keys, vals):
        err, tol, _ = stream_grad_err(name, keys, vals, T, stream_table_grad(
            name, keys, vals, T))
        return err, tol

    errs = {
        "brick3_table_grad": lambda x, g: brick3_grad_err(
            x, g, hcfg, hashgrid_table_grad_brick3(x, g, hcfg)),
        "hashgrid_table_grad_window": lambda x, g: stream_err(
            "tcnn_table_grad", *tcnn_stream(*hashgrid_indices_cm(x, hcfg),
                                            g)),
        "sorted_table_grad_window_pair": lambda x, g: stream_err(
            "slab_table_grad", *slab_stream(x, g, hcfg)),
        "sorted_table_grad_brick": lambda x, g: stream_err(
            "brick_table_grad", *brick_stream(x, g, hcfg)),
    }
    recs = {key: [] for key in errs}
    for case, (x, g) in aggregation_inputs(n, hcfg.n_levels, dev).items():
        at = f"aggregation stream: {case}"
        for key, err_fn in errs.items():
            e, t = err_fn(x, g)
            torch.cuda.synchronize()
            check(bool((e <= t).all()), f"{key} kernel vs plain at {at}: "
                                        f"max|diff| {float(e.max())}")
            recs[key].append({
                "at": at, "check": ORDER_CHECK,
                "shape": f"{x.shape[0]} samples",
                "max_abs_err": float(e.max()),
                "max_err_over_tol": float((e / t.clamp_min(1e-30)).max())})
            print(f"[aggregation] {key} at {at} ({x.shape[0]} samples): "
                  f"{ORDER_CHECK} ok, max|diff| {float(e.max()):.3g}, "
                  f"{recs[key][-1]['max_err_over_tol']:.3g} of its bound")
    return recs


def forward_times(table, xn, hcfg) -> dict:
    """Median ms of each family's forward at one microbatch's samples:
    the PyTorch gathers of the tcnn hash (bf16 and f32), slab ('plain'
    and the dedup forward over its addressing) and brick, beside the
    brick3 kernel."""
    packed = pack_brick3_table(table)
    fwds = {
        "tcnn bf16 (window, dedup, sort, pallas, xla)":
            lambda: hashgrid_encode(table, xn, hcfg, torch.bfloat16),
        "tcnn f32 (every f32 run)":
            lambda: hashgrid_encode(table, xn, hcfg, torch.float32),
        "slab plain": lambda: hashgrid_slab.hashgrid_encode_slab_fwd_impl(
            table, xn, hcfg),
        "slab dedup": lambda: hashgrid_encode_dedup_fwd_impl(
            table, xn, hcfg, torch.bfloat16, addr="slab"),
        "brick": lambda: hashgrid_brick.hashgrid_encode_brick_fwd_impl(
            table, xn, hcfg),
        "brick3 (kernel 1, packed)": lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed),
        "brick3 (kernel 1, f32 table)":
            lambda: hashgrid_encode_brick3_fwd_impl(table, xn, hcfg),
    }
    out = {k: median_ms(f, reps=10, warmup=2) for k, f in fwds.items()}
    print(f"[forwards] {xn.shape[0]} samples, L={hcfg.n_levels}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def print_check(name: str, rec: dict) -> None:
    extra = (f", {rec['max_err_over_tol']:.3g} of its bound"
             if "max_err_over_tol" in rec else "")
    if "zero_fill_ms" in rec:
        extra += f", zero-fill {rec['zero_fill_ms']:.4f} ms"
    if "device_ms" in rec:
        lib = rec["library_device_ms"]
        extra += (f"; on the device (CUDA graph) {rec['device_ms']:.4f} ms, "
                  f"library {'none' if lib is None else f'{lib:.4f} ms'}")
    if "exact_share" in rec:
        extra += (f", exact share {rec['exact_share']:.6f} packed / "
                  f"{rec['exact_share_f32']:.6f} f32; train path (f32 "
                  f"table) {rec['train_path_device_ms']:.4f} ms on the "
                  f"device, bound {rec['train_path_bound_ms']:.4f} ms; "
                  f"the pack alone {rec['pack_device_ms']:.4f} ms")
    if "contract_ms" in rec:
        extra += (f", contract {rec['contract']} in "
                  f"{rec['contract_ms']:.4f} ms")
    print(f"[kernels] {name} at {rec['at']}: {rec['check']} ok (max|diff| "
          f"{rec['max_abs_err']:.3g}{extra}) on {rec['shape']}; median "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']}, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn without the host time between calls:
    `reps` calls captured in a CUDA graph, one replay timed by CUDA
    events, divided by reps. (An event pair around a single call of a
    ~10 us kernel also counts the wrapper's Python and ctypes time.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gather_check(name: str, fn, plain, library, args, n_bytes: int,
                 shape: str, edge_args=None,
                 edges: str = "rows from the end and outside the table, "
                              "lanes outside [0, 128)") -> dict:
    """A gather kernel of the examples against its plain twin (must be
    bit-equal, as 32-bit words so that NaN rows compare, on the script's
    draw and, where given, on its edge draw), with the times of the
    kernel's wrapper, of the twin and of one PyTorch call for the same
    gather, the wrapper's and the library call's device time alone
    (graph_ms), and the bytes bound."""
    errs = []
    for draw in (args, edge_args) if edge_args is not None else (args,):
        got, ref = fn(*draw), plain(*draw)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"{name} kernel != plain twin")
        # NaN - NaN where both gathered NaN: bit-equal there
        diff = (got.double() - ref.double()).abs().nan_to_num(nan=0.0)
        errs.append(float(diff.max()))
    rec = {
        "at": "examples (the script's default size)", "check": "bit-equal",
        "max_abs_err": max(errs), "shape": shape,
        "ms": median_ms(lambda: fn(*args)),
        "device_ms": graph_ms(lambda: fn(*args)),
        "plain_ms": median_ms(lambda: plain(*args)),
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
    }
    if edge_args is not None:
        rec["edge_check"] = f"bit-equal on the edge draw (with_edges: {edges})"
    rec.update(bound(n_bytes, 0))
    return rec


def vmem_gather_checks(E: int, R: int, dev) -> dict:
    """tal_sublane and rowgather_onehot through their wrappers on the
    script's draw and its edge draw, at E words from an (R, 128) table,
    keyed by the kernel the wrapper launches at this R."""
    x = tvg.make_inputs(E, R, dev)
    edges = tvg.with_edges(x, R)
    tbl, rows_l = x["tbl"], x["rows2d"].long()
    flat_l = ((x["row"].long() << 7) | x["lane"].long()).reshape(-1)
    idx_bytes = E * 4                                  # one int32 index each
    tal = tvg.tal_kernel(R)
    recs = {
        tal: gather_check(
            tal, tvg.tal_sublane, tvg.tal_sublane_plain,
            # take_along_axis over the rows (int64 indices, as torch takes)
            lambda: torch.gather(tbl, 0, rows_l), (tbl, x["rows2d"]),
            R * 128 * 4 + idx_bytes + E * 4,
            f"E={E} words from a ({R}, 128) int32 table",
            (tbl, edges["rows2d"])),
        "rowgather_onehot": gather_check(
            "rowgather_onehot", tvg.rowgather_onehot,
            tvg.rowgather_onehot_plain,
            lambda: torch.take(tbl, flat_l), (tbl, x["row"], x["lane"]),
            R * 128 * 4 + 2 * idx_bytes + E * 4,
            f"E={E} words (row, lane) from a ({R}, 128) int32 table",
            (tbl, edges["row"], edges["lane"])),
    }
    for rec in recs.values():
        rec["at"] = f"examples (the script's default E, R = {R})"
    return recs


def examples_phase(dev) -> tuple:
    """Phase 8: bench_vmem_gather (at its default table and at
    WIDE_ROWS, too large for tal_sublane to stage) and proto_pallas_gather
    run at their default sizes (their kernels' launches counted), then
    each of their five kernels against its plain twin at those sizes
    (rowgather_onehot at both tables); then profile_step at its
    defaults. Returns ({kernel: check record}, launch counts of the
    scripts' runs, profile_step's times)."""
    E, R = tvg.ELEMS, tvg.R
    T, M = tpg.T, tpg.M
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tvg.run(E, R, device=dev)
    tvg.run(E, WIDE_ROWS, device=dev)
    tpg.run(T, M, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    print(f"[examples] launches of the scripts' runs: {launches}")

    recs = vmem_gather_checks(E, R, dev)
    wide = vmem_gather_checks(E, WIDE_ROWS, dev)
    recs["tal_sublane_l2"] = wide["tal_sublane_l2"]
    # rowgather_onehot has one kernel for any R: the wide table's check
    # stands beside the default one
    rec = recs["rowgather_onehot"]
    rec["wide_table"] = wide["rowgather_onehot"]
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             rec["wide_table"]["max_abs_err"])
    p = tpg.make_inputs(T, M, dev)
    table, idx, vals = p["table"], p["idx"], p["vals"]
    recs["pallas_gather"] = gather_check(
        "pallas_gather", tpg.pallas_gather, tpg.pallas_gather_plain,
        lambda: torch.index_select(table, 0, idx), (table, idx),
        M * 4 + M * 8 + T * 8, f"M={M} rows from a ({T}, 2) f32 table",
        (table, tpg.with_edges(p, T)["idx"]),
        "indices from the end and outside the table")

    got = tpg.pallas_scatter(idx, vals, T)
    ref = tpg.pallas_scatter_plain(idx, vals, T)
    tol = tpg.scatter_order_bound(idx, vals, T)
    err = (got - ref).abs()
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"pallas_scatter kernel vs plain: "
                                    f"max|diff| {float(err.max())}")
    rec = recs["pallas_scatter"] = {
        "at": "examples (the script's default size)",
        "check": "within 2 (n - 1) 2^-24 sum|terms| per entry (atomic "
                 "summation order)",
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"M={M} (row, 2) updates into a ({T}, 2) f32 table",
        "ms": median_ms(lambda: tpg.pallas_scatter(idx, vals, T)),
        # the zero-fill and the atomics
        "device_ms": graph_ms(lambda: tpg.pallas_scatter(idx, vals, T)),
        "plain_ms": median_ms(lambda: tpg.pallas_scatter_plain(idx, vals,
                                                               T)),
        "library_ms": median_ms(lambda: torch.zeros(
            (T, 2), device=dev).index_add_(0, idx, vals)),
        "library_device_ms": graph_ms(lambda: torch.zeros(
            (T, 2), device=dev).index_add_(0, idx, vals)),
    }
    # idx and vals read once, the table written once; two f32 adds an update
    rec.update(bound(M * 4 + M * 8 + T * 8, 2 * M))
    for name, r in recs.items():
        print_check(name, r)
    print_check("rowgather_onehot", recs["rowgather_onehot"]["wide_table"])
    del p, table, idx, vals, got, ref, tol, err

    t0 = time.perf_counter()
    prof = profile_step.run(device=dev)
    print(f"[examples] profile_step at its defaults in "
          f"{time.perf_counter() - t0:.1f} s")
    return recs, launches, {k: 1e3 * v for k, v in prof.items()}


def microbatch_rays(trainer) -> tuple:
    """One 2048-ray microbatch's draws from seed 7 (the generator, the
    batch) and its rays' origins, directions, near and far."""
    dev = trainer.data["directions"].device
    gen = torch.Generator(device=dev).manual_seed(7)
    mb = trainer.tcfg.batch_size // trainer.tcfg.n_microbatch
    batch = tt.sample_batch(gen, trainer.data, mb)
    poses = trainer.data["poses"][batch["img_idxs"]]
    rays_o, rays_d = get_rays(trainer.data["directions"][batch["pix_idxs"]],
                              poses)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    center, half = scene_center_half(trainer.model_state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    return gen, batch, rays_o, rays_d, t1, t2


def microbatch(trainer) -> dict:
    """One 2048-ray microbatch (draws from seed 7) of the trainer's
    current parameters, grids and budget: the union march's lattice
    candidates (xyz, dt) and union grid, its marched samples xn in
    [0, 1]^3, and a random output gradient g on the valid slots, zero
    elsewhere (as the path gives)."""
    hcfg = trainer.cfg.hash
    gen, batch, rays_o, rays_d, t1, t2 = microbatch_rays(trainer)
    dev, state = rays_o.device, trainer.model_state
    mcfg = trainer.rcfg.march(trainer.cfg)
    _, dt, xyz, _ = _lattice_candidates(rays_o, rays_d, t1, t2, mcfg,
                                        batch["noise"])
    m, _ = march_rays_union_flat(
        rays_o, rays_d, t1, t2, state["occ"], mcfg, batch["noise"],
        budget_per_ray=trainer.rcfg.budget_per_ray,
        cap_scale=trainer.cfg.n_experts)
    rid = m["ray_id"].long()
    x = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    g = torch.randn((xn.shape[0], 2 * hcfg.n_levels), generator=gen,
                    device=dev)
    return {"xyz": xyz, "dt": dt, "mcfg": mcfg,
            "occ_union": state["occ"].any(dim=0).contiguous(), "xn": xn,
            "g": torch.where(m["valid"][:, None], g, 0.0).contiguous(),
            "n_valid": int(m["total"])}


def microbatch_checks(trainer, at: str, streams: bool = False) -> dict:
    """Kernels 1-3 against their plain versions at one training
    microbatch's shapes (`microbatch`): kernel 2 on the lattice
    candidates, kernels 1 and 3 on the marched samples and gradient; with
    `streams`, also kernels 4-7 and the forwards' times on the same
    samples and gradient. Returns {kernel name or contract: check record}
    (and "forward_ms")."""
    b = microbatch(trainer)
    hcfg = trainer.cfg.hash
    xn, g, n_valid = b["xn"], b["g"], b["n_valid"]
    table = trainer.bundle["model"]["hash_table"].detach()
    recs = {
        "occ_lookup": occ_check(b["xyz"], b["dt"], b["occ_union"],
                                b["mcfg"], at),
        "brick3_encode_fwd": encode_check(
            table, pack_brick3_table(table), xn, hcfg, at, n_valid),
        "brick3_table_grad": table_grad_check(xn, g, hcfg, at, n_valid),
    }
    if streams:
        recs.update(stream_checks(xn, g, hcfg, at))
    for name, rec in recs.items():
        print_check(name, rec)
    if streams:
        recs["forward_ms"] = forward_times(table, xn, hcfg)
    return recs


def encode_times(trainer, label: str) -> dict:
    """The trainer's hash encode alone at one microbatch of its current
    state, as the step runs it (differentiable, no pre-packed table):
    median ms of the forward and of the backward (the table gradient:
    corners computed again, the stream built, the kernel)."""
    b = microbatch(trainer)
    cfg = trainer.cfg
    table = trainer.bundle["model"]["hash_table"].detach().requires_grad_()

    def fwd():
        return encode_dispatch(table, b["xn"], cfg.hash, cfg.cdtype,
                               cfg.hash_impl)

    out = fwd()
    g = b["g"].to(out.dtype)
    rec = {"samples": b["xn"].shape[0],
           "forward_ms": median_ms(fwd, reps=10, warmup=2),
           "backward_ms": median_ms(lambda: torch.autograd.grad(
               out, table, g, retain_graph=True), reps=10, warmup=2)}
    print(f"[{label}] the {cfg.hash_impl} encode alone at one microbatch "
          f"({rec['samples']} samples, budget "
          f"{trainer.rcfg.budget_per_ray}): forward {rec['forward_ms']:.3f} "
          f"ms, backward {rec['backward_ms']:.3f} ms")
    return rec


def grid_update_check(trainer) -> dict:
    """Kernel 1 against its plain version on one expert's warmup grid
    update: every cell of the grid at its jittered position."""
    cfg = trainer.cfg
    dev = trainer.data["directions"].device
    gen = torch.Generator(device=dev).manual_seed(8)
    xyz = cell_world_positions(all_cell_coords(cfg, dev), 0, cfg, gen)
    state = trainer.model_state
    xn = ((xyz - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    table = trainer.bundle["model"]["hash_table"].detach()
    rec = encode_check(table, pack_brick3_table(table), xn, cfg.hash,
                       "warmup grid update", xn.shape[0], plain_reps=10)
    print_check("brick3_encode_fwd", rec)
    return rec


def ray_store(cfg: MNGPConfig, dev) -> dict:
    """The training phases' ray store and its target colours."""
    t0 = time.perf_counter()
    store = sphere_store(STORE_IMAGES, STORE_SIDE, dev)
    store["rays"] = render_sphere(store, cfg)
    torch.cuda.synchronize()
    n_rays = store["rays"].shape[0] * store["rays"].shape[1]
    print(f"[train] ray store: {n_rays} rays ({STORE_IMAGES} cameras x "
          f"{STORE_SIDE}x{STORE_SIDE}), targets rendered in "
          f"{time.perf_counter() - t0:.1f} s; mean colour "
          f"{float(store['rays'].mean()):.4f}")
    return store


def new_trainer(cfg: MNGPConfig, store: dict, dev, layout: str = "flat"):
    """A trainer at TrainConfig's defaults (on `layout`) from seeds 1
    (weights) and 2 (draws), with empty grids."""
    tcfg = tt.TrainConfig(layout=layout)
    gen = torch.Generator().manual_seed(1)
    trainer = tt.Trainer(cfg, tcfg, init_mngp(gen, cfg, device=dev),
                         init_ray_gate(gen, cfg.n_experts, device=dev),
                         init_mngp_state(cfg, device=dev), store,
                         torch.Generator(device=dev).manual_seed(2))
    check(tcfg.n_microbatch == 4, "batch 8192 must take 4 microbatches")
    return trainer


def fit(trainer, n_steps: int, label: str) -> tuple:
    """n_steps of Trainer.fit_steps, the launch counts reset just before
    and read just after. Returns (launch counts, summary): train rays/s
    (median over the steps after the first 16), PSNR of the first and
    last 16 steps, the last loss, the budget and the seconds."""
    tcfg = trainer.tcfg
    log, secs = [], []
    t_last = [0.0]
    every = max(n_steps // 10, 1)

    def on_step(step, loss, aux):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now
        log.append({"loss": float(loss), "psnr": float(aux["psnr"])})
        if step % every == 0 or step == n_steps - 1:
            print(f"[{label}] step {step}: loss {log[-1]['loss']:.5f} psnr "
                  f"{log[-1]['psnr']:.2f} budget "
                  f"{trainer.rcfg.budget_per_ray} util "
                  f"{float(aux['budget_util']):.3f} occupied "
                  f"{float(trainer.model_state['occ'].float().mean()):.4f}")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_last[0] = t0 = time.perf_counter()
    trainer.fit_steps(n_steps, on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    rates = [tcfg.batch_size / s for s in secs[16:]]
    psnrs = [r["psnr"] for r in log]
    first, last = float(np.mean(psnrs[:16])), float(np.mean(psnrs[-16:]))
    print(f"[{label}] {n_steps} steps of {tcfg.batch_size} rays in "
          f"{total:.1f} s; train rays/s median {np.median(rates):.0f} over "
          f"steps 16-{n_steps - 1} (min {min(rates):.0f}, max "
          f"{max(rates):.0f}); psnr {first:.2f} -> {last:.2f} dB (mean of "
          f"the first and last 16 steps); budget "
          f"{trainer.rcfg.budget_per_ray}; launches {launches}")
    check(all(np.isfinite([r["loss"] for r in log])),
          f"non-finite training loss ({label})")
    return launches, {
        "steps": n_steps, "rays_per_s": float(np.median(rates)),
        "psnr_first": first, "psnr_last": last,
        "loss_last": log[-1]["loss"],
        "budget_per_ray": trainer.rcfg.budget_per_ray, "seconds": total}


def check_launches(launches: dict, cfg: MNGPConfig, n_steps: int,
                   mb: int, label: str) -> None:
    """Exact launch counts of a training run: the family's table-gradient
    kernel and the occupancy kernel once per microbatch, the brick3
    encode kernel once per microbatch and once per expert and cascade of
    each grid update (brick3 only), every other kernel never."""
    family = cfg.hash_impl if cfg.cdtype == torch.bfloat16 else "dedup"
    n_updates = -(-n_steps // tt.UPDATE_INTERVAL)
    want = {name: 0 for name in launches}
    want["occ_lookup"] = mb * n_steps
    want[FAMILY_KERNELS[family]] = mb * n_steps
    if family == "brick3":
        want["brick3_encode_fwd"] = (
            mb * n_steps + n_updates * cfg.n_experts * cfg.cascades)
    check(launches == want, f"{label} launches {launches}, expected {want}")


def train_phase(cfg: MNGPConfig, store: dict, dev) -> tuple:
    """Phase 5, brick3 at full width. Returns ({kernel or contract: its
    check records at training shapes}, launch counts of the TRAIN_STEPS
    steps, summary)."""
    trainer = new_trainer(cfg, store, dev)
    trainer.update_grid(warmup=True)        # the state a first step sees
    checks = microbatch_checks(
        trainer, f"train step 0 (budget {trainer.rcfg.budget_per_ray})",
        streams=True)
    forwards = checks.pop("forward_ms")
    checks = {name: [rec] for name, rec in checks.items()}
    for key, recs in aggregation_checks(cfg.hash, AGG_SAMPLES, dev).items():
        checks[key] += recs
    checks["brick3_encode_fwd"].append(grid_update_check(trainer))
    trainer.model_state = init_mngp_state(cfg, device=dev)

    launches, summary = fit(trainer, TRAIN_STEPS, "train")
    check(summary["psnr_last"] > summary["psnr_first"] + 3.0,
          f"psnr did not rise: {summary}")
    mb = trainer.tcfg.n_microbatch
    check_launches(launches, cfg, TRAIN_STEPS, mb, "brick3 training")

    for name, rec in microbatch_checks(
            trainer, f"train step {TRAIN_STEPS} (budget "
                     f"{trainer.rcfg.budget_per_ray})").items():
        checks[name].append(rec)
    summary["profile"] = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, trainer.tcfg.batch_size)),
        f"one training step ({trainer.tcfg.batch_size} rays, {mb} "
        f"microbatches)")
    summary["forward_ms"] = forwards
    summary["encode_ms"] = encode_times(trainer, "train")
    # the trained gate's output layer cancels (TRAIN_CPU_GRAD_RTOL): held
    # at its term scale on the card's forward, every other leaf unpinned
    summary["vs_cpu"] = train_vs_cpu(trainer, pin_gate=True)
    return checks, launches, summary


def family_phase(cfg: MNGPConfig, store: dict, dev, n_steps: int,
                 label: str, profile: bool = False,
                 pin_forward: bool = False) -> tuple:
    """A fresh trainer of cfg's family trained n_steps steps: finite
    losses, exact launch counts, optionally a profiled step, and a 256-ray
    card-vs-CPU step (see train_vs_cpu for `pin_forward`).
    Returns (trainer, launch counts, summary)."""
    t0 = time.perf_counter()
    trainer = new_trainer(cfg, store, dev)
    launches, summary = fit(trainer, n_steps, label)
    mb = trainer.tcfg.n_microbatch
    check_launches(launches, cfg, n_steps, mb, label)
    if profile:
        summary["profile"] = profile_call(
            lambda: trainer.train_step(tt.sample_batch(
                trainer.gen, trainer.data, trainer.tcfg.batch_size)),
            f"one {label} training step ({trainer.tcfg.batch_size} rays, "
            f"{mb} microbatches)")
    summary["encode_ms"] = encode_times(trainer, label)
    summary["vs_cpu"] = train_vs_cpu(trainer, label=label,
                                     pin_forward=pin_forward)
    summary["phase_seconds"] = time.perf_counter() - t0
    return trainer, launches, summary


def leaf_report(paths, card, cpu, scale: dict | None = None) -> list:
    """Per gradient leaf: max|card - cpu| / max|cpu| (or / scale[path]
    where given), the index of its worst entry and the two values
    there."""
    rows = []
    for path, a, c in zip(paths, card, cpu):
        d = (a - c).abs().reshape(-1)
        k = int(d.argmax())
        ref = (scale or {}).get(path, float(c.abs().max()))
        rows.append({
            "leaf": path,
            "ratio": float(d[k]) / max(ref, 1e-30),
            "at": [int(i) for i in np.unravel_index(k, tuple(a.shape))],
            "card": float(a.reshape(-1)[k]), "cpu": float(c.reshape(-1)[k])})
    return rows


class StepProbe:
    """What one training step's render computes on its way, seen through
    models/mlp.py's layer_tap and a pass-through wrapper of the name
    render/ml_render.py calls for the encode (the step runs the port's own
    code): the encode's features, every MLP input, and each layer's
    product and output before its activation, in call order and named by
    the bundle's MLP they belong to (`bind`; apply_mlp on any other
    parameters fails the check); and the ray gate's output layer, its
    input and (once backward has run) its output's gradient. With `pin` (a
    probe recorded on another device, the same step) the step takes that
    probe's forward: each encode feature, MLP input and layer output is
    replaced by the pinned value (the gradient path stays this device's:
    ref + (h - h)), after measuring how far this device's own value,
    computed from the same (pinned) inputs, lies from it: `feat_equal`;
    per MLP input max |x - ref| / (ulp(x) + 2^-16) and per layer max
    |h - ref| / (ulp(mm) + ulp(h) + 2 K 2^-23 (|x| @ |w|)), both in `gap`
    (see TRAIN_CPU_GRAD_RTOL)."""

    def __init__(self, pin: "StepProbe | None" = None):
        self.feat, self.inputs, self.layers = [], [], []
        self.pin = pin
        self.feat_equal, self.gap = True, []
        self.gate_out, self.names = {}, {}

    def bind(self, bundle) -> None:
        """Name the MLPs of the bundle that the step runs on, by the
        identity of the parameter dicts apply_mlp receives."""
        self.names = {id(bundle["gate"]["encoder"]): "gate",
                      id(bundle["model"]["geo"]): "geo",
                      id(bundle["model"]["rgb"]): "rgb"}

    @staticmethod
    def _pinned(mine: list, pinned: list, key):
        """The pinned probe's record at this call, which must be of the
        same MLP and layer."""
        rec = pinned[len(mine)]
        check(rec[0] == key, f"StepProbe: {key} replayed against {rec[0]}")
        return rec

    @staticmethod
    def _take(h, ref):
        return ref + (h - h.detach())

    def _encode(self, params, state, cfg, xyz, packed=None):
        out = self._encode_fn(params, state, cfg, xyz, packed=packed)
        if self.pin is not None:
            ref = self.pin.feat[len(self.feat)].to(out.device)
            self.feat_equal &= bool(torch.equal(out.detach(), ref))
            out = self._take(out, ref)
        self.feat.append(out.detach())
        return out

    def mlp_input(self, params, x):
        key = self.names.get(id(params))
        check(key is not None, "StepProbe: apply_mlp ran on parameters "
                               "outside the bundle's gate, geo and rgb MLPs")
        if self.pin is not None:
            ref = self._pinned(self.inputs, self.pin.inputs,
                               key)[1].to(x.device)
            xd = x.detach()
            self.gap.append(float(((xd.float() - ref.float()).abs() / (
                bf16_ulp(torch.maximum(xd.abs(), ref.abs()))
                + 2.0**-16)).max()))
            x = self._take(x, ref)
        self.inputs.append((key, x.detach()))
        return x

    def layer(self, params, i, x, mm, out):
        key = (self.names[id(params)], i)
        last = i == len(params["w"]) - 1
        if self.pin is not None:
            _, ref, ref_mm, _ = self._pinned(self.layers, self.pin.layers,
                                             key)
            ref, ref_mm = ref.to(out.device), ref_mm.to(out.device)
            w = params["w"][i].detach().to(x.dtype).float()
            acc = 2 * w.shape[-2] * 2.0**-23 * torch.matmul(
                x.detach().float().abs(), w.abs())
            tol = (bf16_ulp(torch.maximum(mm.detach().abs(), ref_mm.abs()))
                   + bf16_ulp(torch.maximum(out.detach().abs(), ref.abs()))
                   + acc)
            self.gap.append(float(((out.detach().float() - ref.float())
                                   .abs() / tol).max()))
            out = self._take(out, ref)
        if key[0] == "gate" and last:
            self.gate_out = {"layer": i, "x": x.detach()}
            if out.requires_grad:
                out.register_hook(
                    lambda g: self.gate_out.update(grad=g.detach()))
        self.layers.append((key, out.detach(), mm.detach(), not last))
        return out

    @contextlib.contextmanager
    def patched(self):
        self._encode_fn = ml_render_mod._encode
        ml_render_mod._encode = self._encode
        try:
            with layer_tap(self):
                yield self
        finally:
            ml_render_mod._encode = self._encode_fn


def probe_diffs(card: StepProbe, cpu: StepProbe) -> dict:
    """Where the card's forward left the CPU's (each side's own step):
    differing encode features; per MLP layer, differing outputs and
    (hidden layers) flipped ReLU decisions."""
    return {
        "feat_diff": sum(int((x.cpu() != y).sum())
                         for x, y in zip(card.feat, cpu.feat)),
        "layer_diff": [int((x.cpu() != y).sum())
                       for (_, x, _, _), (_, y, _, _) in zip(card.layers,
                                                             cpu.layers)],
        "relu_flips": [int(((x.cpu() > 0) != (y > 0)).sum())
                       for (_, x, _, hid), (_, y, _, _) in zip(card.layers,
                                                               cpu.layers)
                       if hid]}


class RouteTap:
    """The switch's point gate routed alike on two devices: in `record`
    the gate's top-k order (models/gates.py::top_k) of each call is kept;
    in `replay` each call takes the recorded order of the same call (the
    same slots), so a hard top-1 that flips on a near tie between the
    card's and the CPU's sums does not send a sample through another
    expert. Each flipped slot is measured against a tie: the gap between
    its two noisy logits here must be within 2 bf16 ulps of the larger
    clean logit, plus 2^-6 of the larger noise term (its noise scale is a
    softplus of a bf16 logit); `report` gives the slots seen, the flips,
    their share and the worst gap over that tie bound (<= 1)."""

    def __init__(self):
        self.orders, self.mode, self.n = [], None, 0
        self.slots = self.flips = 0
        self.worst = 0.0
        self.last = None

    @contextlib.contextmanager
    def _patched(self, mode: str):
        self.mode, self.n = mode, 0
        if mode == "record":
            self.orders = []
        saved = gates_mod.point_gate_logits, gates_mod.top_k
        self._logits_fn, self._top_k_fn = saved

        def logits(*args, **kw):
            self.last = self._logits_fn(*args, **kw)
            return self.last

        gates_mod.point_gate_logits, gates_mod.top_k = logits, self._top_k
        try:
            yield self
        finally:
            gates_mod.point_gate_logits, gates_mod.top_k = saved
            check(mode == "record" or self.n == len(self.orders),
                  f"RouteTap: {self.n} gate calls replayed against "
                  f"{len(self.orders)} recorded")

    def record(self):
        return self._patched("record")

    def replay(self):
        return self._patched("replay")

    def _top_k(self, x, k):
        vals, idx = self._top_k_fn(x, k)
        if self.mode == "record":
            self.orders.append(idx.detach().cpu())
            return vals, idx
        check(self.n < len(self.orders), "RouteTap: more gate calls than "
                                         "recorded")
        ref = self.orders[self.n].to(idx.device)
        self.n += 1
        check(ref.shape == idx.shape, f"RouteTap: gate call of {idx.shape} "
                                      f"replayed against {ref.shape}")
        flipped = ref[:, 0] != idx[:, 0]
        self.slots += idx.shape[0]
        if bool(flipped.any()):
            clean, noisy, _ = (t.detach().float() for t in self.last)
            a, b = ref[flipped, :1], idx[flipped, :1]
            pick = lambda t, i: t[flipped].gather(1, i)[:, 0]
            gap = (pick(noisy, a) - pick(noisy, b)).abs()
            big = torch.maximum(pick(clean, a).abs(), pick(clean, b).abs())
            term = torch.maximum((pick(noisy, a) - pick(clean, a)).abs(),
                                 (pick(noisy, b) - pick(clean, b)).abs())
            tol = 2 * bf16_ulp(big) + 2.0**-6 * term
            self.flips += int(flipped.sum())
            self.worst = max(self.worst, float((gap / tol).max()))
        return x.gather(1, ref), ref

    def report(self) -> dict:
        return {"slots": self.slots, "flips": self.flips,
                "share": self.flips / max(self.slots, 1),
                "worst_gap_over_tie": self.worst}

    def check_ties(self, label: str) -> dict:
        rep = self.report()
        check(rep["worst_gap_over_tie"] <= 1.0,
              f"{label}: a routing flip that is not a near tie ({rep})")
        check(rep["share"] <= 1e-3, f"{label}: routing flips on more than "
                                    f"0.1% of the slots ({rep})")
        return rep


def cpu_step(trainer, cfg, batch, where, probe: StepProbe | None = None):
    """One step of the batch's rays from the trainer's parameters and
    state on `where` under cfg: (loss, aux, gradient leaves on the
    CPU)."""
    move = lambda t: t.detach().to(where)
    bundle = tree_unflatten(trainer.bundle,
                            [move(p) for p in tree_leaves(trainer.bundle)])
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    state = {k: move(v) for k, v in trainer.model_state.items()}
    data = {k: move(v) for k, v in trainer.data.items()}
    b = {k: move(v) for k, v in batch.items()}
    vg = microbatched_value_and_grad(lambda p, bt: trainer.loss_fn(
        p, state, bt, data, cfg, trainer.rcfg, trainer.tcfg), 1)
    if probe is not None:
        probe.bind(bundle)
    with (probe.patched() if probe is not None
          else contextlib.nullcontext()):
        (loss, aux), grads = vg(bundle, b)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [g.cpu() for g in tree_leaves(grads)])


def train_vs_cpu(trainer, cfg: MNGPConfig | None = None,
                 loss_rtol: float = TRAIN_CPU_LOSS_RTOL,
                 grad_rtol: float = TRAIN_CPU_GRAD_RTOL,
                 label: str = "train", pin_forward: bool = False,
                 pin_gate: bool = False, rays: int = CPU_RAYS,
                 grad_launches: int = 1, batch_extra=None,
                 route: "RouteTap | None" = None) -> dict:
    """One step of `rays` rays (256 by default) at full width on the card
    and on the CPU (plain versions) from the trainer's parameters and
    state and the same draws (seed 3), under `cfg` (default the
    trainer's): sample counts, loss and every gradient leaf, each leaf
    reported by its path with its worst entry; the card's step launches
    the family's table-gradient kernel `grad_launches` times (once per
    hash table it encodes with). With `pin_forward` (see TRAIN_CPU_GRAD_RTOL) the leaves are held
    against the CPU step that takes the card's forward (StepProbe), once
    the encode features are found equal and every MLP layer output within
    its two bf16 roundings of the CPU's, the gate's output layer at its
    term scale; the card's gate leaves halved must fail that comparison.
    The same on each batch of PIN_SEEDS, further 256-ray batches of the
    same state. With `pin_gate` (phase 5's form, seed 3 only) only the
    gate's output layer is held that way; every other leaf against the
    CPU step's own forward, as without either; the planted fault and the
    pinned forward's checks as with `pin_forward`.
    `batch_extra(batch, seed)` adds draws to the batch (the
    switch's gate noise, drawn on the CPU for both sides); with `route`
    (RouteTap) the CPU step routes the point gate as the card's did.
    Returns the report of every batch."""
    cfg = cfg or trainer.cfg
    dev = trainer.data["directions"].device
    cpu_dev = torch.device("cpu")
    paths = tree_paths(trainer.bundle)
    family = cfg.hash_impl if cfg.cdtype == torch.bfloat16 else "dedup"
    kernel = FAMILY_KERNELS[family]
    report = []
    for seed in (3, *PIN_SEEDS) if pin_forward else (3,):
        batch = tt.sample_batch(
            torch.Generator(device=dev).manual_seed(seed), trainer.data,
            rays)
        if batch_extra is not None:
            batch.update(batch_extra(batch, seed))
        pinning = pin_forward or pin_gate
        pg, pc = (StepProbe(), StepProbe()) if pinning else (None, None)
        before = kernels.launch_counts[kernel]
        with route.record() if route else contextlib.nullcontext():
            lg, ag, gg = cpu_step(trainer, cfg, batch, dev, pg)
        check(kernels.launch_counts[kernel] == before + grad_launches,
              f"{label}: the card step did not launch {kernel} "
              f"{grad_launches} times")
        with route.replay() if route else contextlib.nullcontext():
            lc, ac, gc = cpu_step(trainer, cfg, batch, cpu_dev, pc)
        leaves = leaf_report(paths, gg, gc)
        top = max(leaves, key=lambda r: r["ratio"])
        rec = {"seed": seed, "loss": [lg, lc],
               "samples": [ag["rm_samples"], ac["rm_samples"]],
               "worst": top["ratio"], "worst_leaf": top["leaf"]}
        if route is not None:
            rec["route"] = route.report()
        checked = leaves
        if pinning and ag["rm_samples"] == ac["rm_samples"]:
            pin = StepProbe(pin=pg)
            _, _, gp = cpu_step(trainer, cfg, batch, cpu_dev, pin)
            # the gate's output layer at its term scale (see
            # TRAIN_CPU_GRAD_RTOL), every other leaf at its largest entry
            out = pin.gate_out
            t = out["grad"].float().abs()
            scale = {f"gate/encoder/w/{out['layer']}": float(
                         (out["x"].float().abs().T @ t).max()),
                     f"gate/encoder/b/{out['layer']}": float(t.sum(0).max())}
            checked = leaf_report(paths, gg, gp, scale)
            if pin_gate:     # the pinned form for the gate's output only
                checked = [p if p["leaf"] in scale else u
                           for p, u in zip(checked, leaves)]
            top = max(checked, key=lambda r: r["ratio"])
            own = {r["leaf"]: r["ratio"] for r in leaf_report(paths, gg, gp)}
            # planted faults: the card's gate leaves halved, all of them
            # (must fail) and each term-scaled leaf alone (reported)
            half = lambda keep: [0.5 * a if keep(p) else a
                                 for p, a in zip(paths, gg)]
            planted = max(r["ratio"] for r in leaf_report(
                paths, half(lambda p: p.startswith("gate/")), gp, scale))
            alone = {r["leaf"]: r["ratio"] for r in leaf_report(
                paths, half(lambda p: p in scale), gp, scale)}
            rec.update(probe_diffs(pg, pc), feat_equal=pin.feat_equal,
                       rounding_gap=max(pin.gap),
                       rounding_gap_at=int(np.argmax(pin.gap)),
                       worst_pinned=top["ratio"],
                       worst_pinned_leaf=top["leaf"],
                       planted_gate_half=planted,
                       gate_out={k: [own[k], scale[k] / max(
                           float(gp[paths.index(k)].abs().max()), 1e-30),
                           alone[k]] for k in scale})
        worst = max(r["ratio"] for r in checked)
        rec["worst_checked"] = worst
        report.append(rec)
        if seed == 3:
            print(f"[{label}] card vs CPU plain, one {rays}-ray step "
                  f"({cfg.hash_impl}, {cfg.compute_dtype}): loss {lg:.6f} "
                  f"vs {lc:.6f}, samples {ag['rm_samples']:.0f} vs "
                  f"{ac['rm_samples']:.0f}, worst gradient leaf max|diff| / "
                  f"max|ref| {rec['worst']:.3g} over {len(gg)} leaves"
                  + (f", {worst:.3g} with the card's forward"
                     if pin_forward else "")
                  + (f", {worst:.3g} with the gate's output layer at its "
                     f"term scale on the card's forward" if pin_gate
                     else "")
                  + f" (tolerance loss {loss_rtol} relative, leaves "
                  f"{grad_rtol})"
                  + (f"; point gate {rec['route']}" if route else ""))
            for r in leaves:
                print(f"[{label}]   leaf {r['leaf']}: {r['ratio']:.3g} at "
                      f"{tuple(r['at'])}, card {r['card']:.6g} vs CPU "
                      f"{r['cpu']:.6g}")
        if pinning:
            print(f"[{label}] batch seed {seed}: " + json.dumps(rec))
        check(ag["rm_samples"] == ac["rm_samples"],
              f"{label}: card and CPU marched different samples")
        check(abs(lg - lc) <= loss_rtol * abs(lc),
              f"{label}: card vs CPU loss")
        if pinning:
            check(rec.get("feat_equal", False),
                  f"{label}: card and CPU encodes differ")
            check(rec["rounding_gap"] <= 1.0, f"{label}: an MLP output "
                  f"beyond its two bf16 roundings ({rec['rounding_gap']})")
            check(rec["planted_gate_half"] > grad_rtol, f"{label}: the "
                  "card's gate gradient halved passes the check")
        check(worst <= grad_rtol, f"{label}: card vs CPU gradient leaves "
                                  f"(batch seed {seed})")
    return report


def write_tanks_scene(parent: str, cfg: MNGPConfig, dev) -> str:
    """Phase 9's scene on disk, in the NSVF layout of a Tanks and Temples
    scene (the loader's 'Tanks' branch: a 4x4 intrinsics.txt at
    1920x1080, bbox.txt, rgb/{0,1}_*.png, pose/{0,1}_*.txt): the views of
    render_sphere's emissive sphere from shell_poses, at 192x108, written
    with the port's PNG codec. bbox [-1, 1]^3 makes the loader's
    normalized poses shell_poses' (world = normalized x 2.1)."""
    root = os.path.join(parent, "TanksAndTemple", "Sphere")
    for sub in ("rgb", "pose"):
        os.makedirs(os.path.join(root, sub))
    k_full = np.array([[ENTRY_FOCAL, 0, 960], [0, ENTRY_FOCAL, 540],
                       [0, 0, 1]], np.float32)
    k = k_full.copy()
    k[:2] *= 0.1
    w, h = 192, 108
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               np.pad(k_full, ((0, 1), (0, 1))) + np.diag([0, 0, 0, 1]))
    np.savetxt(os.path.join(root, "bbox.txt"),
               [[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.01]])
    poses = shell_poses(ENTRY_VIEWS)
    store = {"poses": torch.tensor(poses, dtype=torch.float32, device=dev),
             "directions": torch.from_numpy(
                 get_ray_directions(h, w, k)).to(dev)}
    imgs = (render_sphere(store, cfg).clamp(0, 1) * 255 + 0.5).to(
        torch.uint8).reshape(ENTRY_VIEWS, h, w, 3).cpu().numpy()
    counts = [0, 0]
    for i, (img, pose) in enumerate(zip(imgs, poses)):
        split = int(i % ENTRY_TEST_EVERY == ENTRY_TEST_EVERY // 2)
        name = f"{split}_{counts[split]:04d}"
        counts[split] += 1
        write_png(os.path.join(root, "rgb", name + ".png"), img)
        c2w = pose.copy()
        c2w[:, 3] *= 2.1
        np.savetxt(os.path.join(root, "pose", name + ".txt"),
                   np.vstack([c2w, [0, 0, 0, 1]]))
    check(counts == [48, 4], f"scene split {counts}")
    return root


def entry_args(root: str, exp: str, *extra) -> list:
    return ["--root_dir", root, "--exp_name", exp, *ENTRY_ARGS, *extra]


def step_timer(secs: list):
    """on_step for train_ml.main: each step's wall time, the step ended
    by a synchronize."""
    last = [time.perf_counter()]

    def on_step(step, loss, aux):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - last[0])
        last[0] = now

    return on_step


def entry_phase(cfg: MNGPConfig, dev, smi: str) -> tuple:
    """Phase 9: the train_ml.py entry point on a scene on disk (see the
    module docstring). Returns (launch counts of the phase, summary)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        root = write_tanks_scene(tmp, cfg, dev)
        cwd = os.getcwd()
        os.chdir(tmp)          # logs/, ckpts/, results/ go under tmp
        try:
            summary = entry_runs(root, dev)
        finally:
            os.chdir(cwd)
    summary["seconds"] = time.perf_counter() - t_phase
    launches = summary.pop("launches")
    print(f"[entry] {summary['seconds']:.1f} s in all; train rays/s median "
          f"{summary['rays_per_s']:.0f} (steps after the first 16 of each "
          f"run); launches {launches}; {smi}")
    return launches, summary


def entry_runs(root: str, dev) -> dict:
    run = os.path.join("TanksAndTemple", "Sphere")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # the untrained system, validated once
    h = get_opts(entry_args(root, "untrained"))
    h.moe_training = True
    untrained = tt.NeRFSystem(h, device=dev)
    untrained.setup()
    decoder = untrained.train_dataset.decoder
    psnr0 = untrained.validate(epoch=0)["psnr"]
    untrained.close()
    del untrained
    print(f"[entry] scene read back by the '{decoder}' decoder; untrained "
          f"test PSNR {psnr0:.3f} dB")

    # train ENTRY_EPOCHS epochs
    secs = [[], []]
    trained = train_ml.main(entry_args(root, "smoke", "--num_epochs",
                                       str(ENTRY_EPOCHS)),
                            device=dev, on_step=step_timer(secs[0]))
    trained.close()
    del trained
    ckpts = os.path.join("ckpts", run, "smoke")
    for name in ("epoch=0.ckpt", "epoch=1.ckpt", "epoch=1_slim.ckpt"):
        check(os.path.exists(os.path.join(ckpts, name)), f"no {name}")
    pngs = sorted(os.listdir(os.path.join("results", run, "smoke")))
    check(pngs == [f"{i:03d}epoch1{d}.png" for i in range(4)
                   for d in ("", "_d")], f"validation images {pngs}")
    with open(os.path.join("logs", run, "smoke", "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr1 = [m["value"] for m in metrics if m["tag"] == "test/psnr"][-1]
    n1 = ENTRY_EPOCHS * ENTRY_STEPS
    print(f"[entry] {n1} steps: test PSNR {psnr0:.3f} -> {psnr1:.3f} dB")
    check(psnr1 >= psnr0 + 3.0, f"test psnr {psnr0} -> {psnr1}")
    check(len(secs[0]) == n1, f"{len(secs[0])} steps")

    # resume for one more epoch
    resumed = train_ml.main(entry_args(root, "smoke", "--num_epochs",
                                       str(ENTRY_EPOCHS + 1), "--resume",
                                       "auto"),
                            device=dev, on_step=step_timer(secs[1]))
    resumed.close()
    del resumed
    n2 = (ENTRY_EPOCHS + 1) * ENTRY_STEPS
    with open(os.path.join("logs", run, "smoke", "log.txt")) as f:
        log = f.read()
    last_ckpt = os.path.join(ckpts, f"epoch={ENTRY_EPOCHS}.ckpt")
    check(f"epoch={ENTRY_EPOCHS - 1}.ckpt at step {n1}" in log
          and len(secs[1]) == ENTRY_STEPS
          and int(load_ckpt(last_ckpt)["step"]) == n2,
          f"the resumed run did not continue at step {n1}")
    with open(os.path.join("logs", run, "smoke", "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr2 = [m["value"] for m in metrics
             if m["tag"] == "test/psnr" and m["step"] == n2][-1]

    # the oracle renders the test split from the last checkpoint
    got = oracle.main(entry_args(root, "oracle", "--moe_training",
                                 "--ckpt_path", last_ckpt), device=dev)
    print(f"[entry] resumed at step {n1}, epoch {ENTRY_EPOCHS} validated "
          f"at {psnr2:.6f} dB; the oracle's render {got['psnr']:.6f} dB")
    check(abs(got["psnr"] - psnr2) <= 1e-3, "oracle psnr")

    # one 256-ray chunk of test view 0 from the checkpoint, card vs CPU
    systems = []
    for device in (dev, "cpu"):
        h = get_opts(entry_args(root, "vs_cpu", "--val_chunk",
                                str(CPU_RAYS)))
        h.moe_training = True
        system = tt.NeRFSystem(h, device=device)
        system.setup()
        system.resume(last_ckpt)
        systems.append(system)
    ds = systems[1].test_dataset
    w, img_h = ds.img_wh
    p0 = (img_h // 2) * w + (w - CPU_RAYS) // 2
    outs = [s.render_view(
        torch.from_numpy(ds.poses[0]).to(s.device),
        torch.from_numpy(ds.directions[p0:p0 + CPU_RAYS]).to(s.device))
        for s in systems]
    diffs = {k: float((outs[0][k].cpu() - outs[1][k]).abs().max())
             for k in CPU_TOL}
    print(f"[entry] card vs CPU, {CPU_RAYS} rays of test view 0 from "
          f"{last_ckpt}: max|diff| {diffs} (tolerance {CPU_TOL}); samples "
          f"{outs[0]['total_samples']} vs {outs[1]['total_samples']}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"entry card vs CPU {k}: {diffs[k]} > {tol}")
    check(outs[0]["total_samples"] == outs[1]["total_samples"],
          "entry render: card and CPU marched different samples")
    for s in systems:
        s.close()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)

    mb = tt.TrainConfig(batch_size=h.batch_size).n_microbatch
    want = mb * n2
    check(launches["brick3_table_grad"] == want,
          f"brick3_table_grad launched {launches['brick3_table_grad']} "
          f"times, expected {want} ({mb} microbatches x {n2} steps)")
    for name in ("brick3_encode_fwd", "occ_lookup"):
        check(launches[name] > want, f"{name} launched {launches[name]}")
    rates = [h.batch_size / s for run_secs in secs for s in run_secs[16:]]
    return {"launches": launches, "decoder": decoder,
            "steps": n2, "psnr_untrained": psnr0, "psnr_trained": psnr1,
            "psnr_resumed": psnr2, "psnr_oracle": got["psnr"],
            "vs_cpu": diffs, "rays_per_s": float(np.median(rates)),
            "rays_per_s_min": float(min(rates)),
            "rays_per_s_max": float(max(rates))}


# ---------------------------------------------------------------- phase 11
def single_args(root: str, exp: str, *extra) -> list:
    return ["--root_dir", root, "--exp_name", exp, *SINGLE_ARGS, *extra]


def single_runs(root: str, dev) -> dict:
    """Phase 11a: train.py's single field through its entry point (see the
    module docstring); returns its summary, its launch counts and the
    resumed system (for the card-vs-CPU render)."""
    from radnerf_tpu_torch.train.__main__ import main as train_main

    run = os.path.join("TanksAndTemple", "Sphere")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    untrained = tt.NeRFSystem(get_opts(single_args(root, "untrained")),
                              device=dev)
    untrained.setup()
    check(not untrained.moe and untrained.gate_params is None,
          "train.py without --moe_training built a MoE")
    psnr0 = untrained.validate(epoch=0)["psnr"]
    untrained.close()
    del untrained

    secs = [[], []]
    trained = train_main(single_args(root, "base", "--num_epochs",
                                     str(ENTRY_EPOCHS)),
                         device=dev, on_step=step_timer(secs[0]))
    trained.close()
    del trained
    ckpts = os.path.join("ckpts", run, "base")
    e = ENTRY_EPOCHS - 1
    for name in (f"epoch={e}.ckpt", f"epoch={e}_slim.ckpt"):
        check(os.path.exists(os.path.join(ckpts, name)), f"no {name}")
    first = load_ckpt(os.path.join(ckpts, f"epoch={e}.ckpt"))
    check("gate_params" not in first
          and first["model_state"]["density_grid"].ndim == 2,
          "the single field's checkpoint holds a gate or stacked grids")
    with open(os.path.join("logs", run, "base", "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr1 = [m["value"] for m in metrics if m["tag"] == "test/psnr"][-1]
    n1 = ENTRY_EPOCHS * ENTRY_STEPS
    print(f"[single] {n1} steps: test PSNR {psnr0:.3f} -> {psnr1:.3f} dB")
    check(psnr1 >= psnr0 + 3.0, f"single test psnr {psnr0} -> {psnr1}")
    check(len(secs[0]) == n1, f"{len(secs[0])} steps")

    # one more epoch, resumed, its checkpoint written in the background
    resumed = train_main(single_args(root, "base", "--num_epochs",
                                     str(ENTRY_EPOCHS + 1), "--resume",
                                     "auto", "--ckpt_backend", "orbax"),
                         device=dev, on_step=step_timer(secs[1]))
    check(resumed.ckpt_writer is not None, "no background writer")
    resumed.close()
    n2 = (ENTRY_EPOCHS + 1) * ENTRY_STEPS
    with open(os.path.join("logs", run, "base", "log.txt")) as f:
        log = f.read()
    last_ckpt = os.path.join(ckpts, f"epoch={ENTRY_EPOCHS}.ckpt")
    last = load_ckpt(last_ckpt)
    check(f"epoch={ENTRY_EPOCHS - 1}.ckpt at step {n1}" in log
          and len(secs[1]) == ENTRY_STEPS and int(last["step"]) == n2
          and int(last["opt_state"]["count"]) == n2,
          f"the resumed run did not continue at step {n1}")
    with open(os.path.join("logs", run, "base", "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr2 = [m["value"] for m in metrics
             if m["tag"] == "test/psnr" and m["step"] == n2][-1]
    got = oracle.main(single_args(root, "oracle", "--ckpt_path", last_ckpt),
                      device=dev)
    print(f"[single] resumed at step {n1} (--ckpt_backend orbax), epoch "
          f"{ENTRY_EPOCHS} validated at {psnr2:.6f} dB; the oracle's render "
          f"{got['psnr']:.6f} dB")
    check(abs(got["psnr"] - psnr2) <= 1e-3, "single oracle psnr")
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    mb = tt.TrainConfig().n_microbatch
    check(launches["brick3_table_grad"] == mb * n2,
          f"brick3_table_grad launched {launches['brick3_table_grad']} "
          f"times, expected {mb * n2} ({mb} microbatches x {n2} steps)")
    for name in ("brick3_encode_fwd", "occ_lookup"):
        check(launches[name] > mb * n2, f"{name} launched {launches[name]}")
    rates = [8192 / s for run_secs in secs for s in run_secs[16:]]
    return {"launches": launches, "system": resumed, "steps": n2,
            "psnr_untrained": psnr0, "psnr_trained": psnr1,
            "psnr_resumed": psnr2, "psnr_oracle": got["psnr"],
            "rays_per_s": float(np.median(rates)),
            "rays_per_s_min": float(min(rates)),
            "rays_per_s_max": float(max(rates))}


def single_vs_cpu(system, store: dict, dev) -> dict:
    """Phase 11b: the single field on the card against the CPU: a
    CHUNK-ray render_test chunk of test view 0 from the resumed system
    (CPU_TOL), and one step-0 microbatch (2048 rays) of a fresh field on
    phase 5's ray store after its warmup grid update
    (TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GRAD_RTOL)."""
    ds = system.test_dataset
    w, img_h = ds.img_wh
    p0 = (img_h // 2) * w - CHUNK // 2
    dirs = torch.from_numpy(ds.directions[p0:p0 + CHUNK])
    pose = torch.from_numpy(ds.poses[0])
    rcfg = system.trainer.rcfg
    outs = [render_rays_chunked(
        to_cpu(system.params) if d == "cpu" else system.params,
        to_cpu(system.model_state) if d == "cpu" else system.model_state,
        system.cfg, None, dirs.to(d), pose.to(d), rcfg, chunk=CHUNK)
        for d in (dev, "cpu")]
    diffs = {k: float((outs[0][k].cpu() - outs[1][k]).abs().max())
             for k in CPU_TOL}
    print(f"[single] card vs CPU plain, a {CHUNK}-ray render_test chunk of "
          f"test view 0: max|diff| {diffs} (tolerance {CPU_TOL}); samples "
          f"{outs[0]['total_samples']} vs {outs[1]['total_samples']}; "
          f"covered {float((outs[1]['opacity'] > 0.01).float().mean()):.3f}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"single render card vs CPU {k}: {diffs[k]}")
    check(outs[0]["total_samples"] == outs[1]["total_samples"],
          "single render: card and CPU marched different samples")

    cfg = NGPConfig(scale=0.5, compute_dtype="bfloat16", hash_impl="brick3")
    gen = torch.Generator().manual_seed(1)
    trainer = tt.Trainer(cfg, tt.TrainConfig(),
                         init_ngp(gen, cfg, device=dev), None,
                         init_ngp_state(cfg, device=dev), store,
                         torch.Generator(device=dev).manual_seed(2))
    trainer.update_grid(warmup=True)        # the state a first step sees
    tcfg = trainer.tcfg
    step = train_vs_cpu(trainer, label="single",
                        rays=tcfg.batch_size // tcfg.n_microbatch)
    profile = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, tcfg.batch_size)),
        f"one single-field training step ({tcfg.batch_size} rays, "
        f"{tcfg.n_microbatch} microbatches, budget "
        f"{trainer.rcfg.budget_per_ray})")
    return {"render": diffs, "step": step, "profile": profile}


def expert_runs(cfg: MNGPConfig, store: dict, dev) -> tuple:
    """Phase 11c: the shared encoder without union sampling (each expert
    its own march, one encode of both sample sets) and unshared_MNGP (a
    table per expert), EXPERT_STEPS steps each from new_trainer's seeds;
    exact launch counts, PSNR rising, a 256-ray card-vs-CPU step, and a
    256-ray ml_render_test chunk card vs CPU. Returns ({path: launch
    counts}, {path: summary})."""
    launches, summaries = {}, {}
    for label, cfg_k, rkw in (
            ("per_expert", cfg, {"union_sampling": False}),
            ("unshared", dataclasses.replace(cfg, shared_encoder=False),
             {})):
        t0 = time.perf_counter()
        trainer = new_trainer(cfg_k, store, dev)
        trainer.rcfg = dataclasses.replace(trainer.rcfg, **rkw)
        n_tables = 1 if cfg_k.shared_encoder else cfg_k.n_experts
        launches[label], summary = fit(trainer, EXPERT_STEPS, label)
        check(summary["psnr_last"] > summary["psnr_first"] + 3.0,
              f"{label} psnr did not rise: {summary}")
        mb = trainer.tcfg.n_microbatch
        K, C = cfg_k.n_experts, cfg_k.cascades
        n_updates = -(-EXPERT_STEPS // tt.UPDATE_INTERVAL)
        want = {name: 0 for name in launches[label]}
        want["occ_lookup"] = K * mb * EXPERT_STEPS
        want["brick3_table_grad"] = n_tables * mb * EXPERT_STEPS
        want["brick3_encode_fwd"] = (n_tables * mb * EXPERT_STEPS
                                     + n_updates * K * C)
        check(launches[label] == want,
              f"{label} launches {launches[label]}, expected {want}")
        summary["profile"] = profile_call(
            lambda: trainer.train_step(tt.sample_batch(
                trainer.gen, trainer.data, trainer.tcfg.batch_size)),
            f"one {label} training step ({trainer.tcfg.batch_size} rays, "
            f"{mb} microbatches, budget {trainer.rcfg.budget_per_ray})")
        summary["vs_cpu"] = train_vs_cpu(trainer, label=label,
                                         grad_launches=n_tables)
        pose = store["poses"][0]
        p0 = (STORE_SIDE // 2) * STORE_SIDE - CPU_RAYS // 2
        dirs = store["directions"][p0:p0 + CPU_RAYS]
        outs = [render_rays_chunked(
            *(to_cpu(x) if d == "cpu" else x for x in (
                trainer.bundle["model"], trainer.model_state)),
            cfg_k, to_cpu(trainer.bundle["gate"]) if d == "cpu"
            else trainer.bundle["gate"], dirs.to(d), pose.to(d),
            trainer.rcfg, chunk=CPU_RAYS) for d in (dev, "cpu")]
        diffs = {k: float((outs[0][k].cpu() - outs[1][k]).abs().max())
                 for k in CPU_TOL}
        print(f"[{label}] card vs CPU plain, a {CPU_RAYS}-ray ml_render_test "
              f"chunk of camera 0: max|diff| {diffs} (tolerance {CPU_TOL}); "
              f"samples {outs[0]['total_samples']} vs "
              f"{outs[1]['total_samples']}")
        for k, tol in CPU_TOL.items():
            check(diffs[k] <= tol, f"{label} render card vs CPU {k}")
        check(outs[0]["total_samples"] == outs[1]["total_samples"],
              f"{label} render: card and CPU marched different samples")
        summary["render_vs_cpu"] = diffs
        summary["phase_seconds"] = time.perf_counter() - t0
        summaries[label] = summary
        del trainer
    return launches, summaries


def smoke_run() -> tuple:
    """Phase 11d: radnerf_tpu_torch.examples.smoke_e2e at its JAX twin's
    defaults (its own check: PSNR up by more than 5 dB); the dedup
    family in float32, so tcnn_table_grad once per step."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = smoke_e2e.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    check(launches["tcnn_table_grad"] == SMOKE_STEPS
          and launches["brick3_table_grad"] == 0,
          f"smoke_e2e launches {launches}")
    return launches, res


def single_phase(cfg: MNGPConfig, store: dict, dev, smi: str) -> tuple:
    """Phase 11 (see the module docstring). Returns ({path: launch
    counts}, summary)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_single_") as tmp:
        root = write_tanks_scene(tmp, cfg, dev)
        cwd = os.getcwd()
        os.chdir(tmp)          # logs/, ckpts/, results/ go under tmp
        try:
            single = single_runs(root, dev)
            system = single.pop("system")
            single["vs_cpu"] = single_vs_cpu(system, store, dev)
            del system
        finally:
            os.chdir(cwd)
    launches = {"single": single.pop("launches")}
    t1 = time.perf_counter()
    single["seconds"] = t1 - t_phase
    print(f"[single] {single['seconds']:.1f} s; train rays/s median "
          f"{single['rays_per_s']:.0f} (steps after the first 16 of each "
          f"run); launches {launches['single']}; {smi}")
    expert_launches, experts = expert_runs(cfg, store, dev)
    launches.update(expert_launches)
    launches["smoke_e2e"], smoke = smoke_run()
    summary = {"single": single, **experts, "smoke_e2e": smoke,
               "seconds": time.perf_counter() - t_phase}
    print(f"[single] phase 11 in {summary['seconds']:.1f} s (the single "
          f"field {single['seconds']:.1f} s, per_expert "
          f"{experts['per_expert']['phase_seconds']:.1f} s, unshared "
          f"{experts['unshared']['phase_seconds']:.1f} s, smoke_e2e "
          f"{smoke['seconds']:.1f} s); {smi}")
    return launches, summary


# ---------------------------------------------------------------- phase 12
def baseline_args(root: str, kind: str, exp: str, *extra) -> list:
    return ["--root_dir", root, "--exp_name", exp, *SINGLE_ARGS,
            *BASELINE_ARGS[kind], *extra]


def baseline_render(kind: str, params, state, cfg, rcfg, anchors,
                    overlap: float):
    """The baseline's test-time chunk render (OtherNeRFSystem.render_chunk)
    on whatever device its tensors lie."""
    def render(rays_o, rays_d):
        if kind == "switch":
            return switch_render_test(params, state, cfg, rays_o, rays_d,
                                      rcfg)
        return block_render_test(params, state, cfg, rays_o, rays_d,
                                 spatial_gating(rays_o, anchors, overlap),
                                 rcfg)
    return render


def baseline_runs(kind: str, root: str, dev) -> dict:
    """Phase 12a/b: train_other.main with the launch script's options (see
    the module docstring): the untrained system validated, ENTRY_EPOCHS
    epochs, one more resumed with --resume auto; returns the summary, its
    launch counts and the resumed system."""
    run = os.path.join("TanksAndTemple", "Sphere")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    untrained = OtherNeRFSystem(get_opts(baseline_args(root, kind,
                                                       "untrained")),
                                device=dev)
    untrained.setup()
    check(not untrained.moe and untrained.gate_params is None
          and untrained.cfg.hash_impl == "auto",
          f"{kind}: the baseline built a gate or took --hash_impl")
    psnr0 = untrained.validate(epoch=0)["psnr"]
    if untrained.anchors is not None:
        print(f"[{kind}] anchors (k-means of the "
              f"{len(untrained.train_dataset.poses)} training cameras' "
              f"centres): {untrained.anchors.cpu().numpy().round(4).tolist()}")
    untrained.close()
    del untrained

    secs = [[], []]
    trained = train_other.main(
        baseline_args(root, kind, kind, "--num_epochs", str(ENTRY_EPOCHS)),
        device=dev, on_step=step_timer(secs[0]))
    trained.close()
    del trained
    ckpts = os.path.join("ckpts", run, kind)
    e = ENTRY_EPOCHS - 1
    for name in (f"epoch={e}.ckpt", f"epoch={e}_slim.ckpt"):
        check(os.path.exists(os.path.join(ckpts, name)), f"no {name}")
    first = load_ckpt(os.path.join(ckpts, f"epoch={e}.ckpt"))
    check("gate_params" not in first
          and first["hparams"]["resolved_hash_impl"] == "brick3",
          f"{kind}: the checkpoint holds a gate or another hash family")
    with open(os.path.join("logs", run, kind, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr1 = [m["value"] for m in metrics if m["tag"] == "test/psnr"][-1]
    n1 = ENTRY_EPOCHS * ENTRY_STEPS
    print(f"[{kind}] {n1} steps: test PSNR {psnr0:.3f} -> {psnr1:.3f} dB")
    check(psnr1 >= psnr0 + 3.0, f"{kind} test psnr {psnr0} -> {psnr1}")
    check(len(secs[0]) == n1, f"{len(secs[0])} steps")

    resumed = train_other.main(
        baseline_args(root, kind, kind, "--num_epochs",
                      str(ENTRY_EPOCHS + 1), "--resume", "auto"),
        device=dev, on_step=step_timer(secs[1]))
    resumed.close()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    n2 = (ENTRY_EPOCHS + 1) * ENTRY_STEPS
    with open(os.path.join("logs", run, kind, "log.txt")) as f:
        log = f.read()
    last = load_ckpt(os.path.join(ckpts, f"epoch={ENTRY_EPOCHS}.ckpt"))
    check(f"epoch={ENTRY_EPOCHS - 1}.ckpt at step {n1}" in log
          and len(secs[1]) == ENTRY_STEPS and int(last["step"]) == n2,
          f"{kind}: the resumed run did not continue at step {n1}")
    with open(os.path.join("logs", run, kind, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr2 = [m["value"] for m in metrics
             if m["tag"] == "test/psnr" and m["step"] == n2][-1]
    print(f"[{kind}] resumed at step {n1}, epoch {ENTRY_EPOCHS} validated "
          f"at {psnr2:.3f} dB")
    mb = tt.TrainConfig().n_microbatch
    check(launches["brick3_table_grad"] == mb * n2,
          f"{kind}: brick3_table_grad launched "
          f"{launches['brick3_table_grad']} times, expected {mb * n2} ({mb} "
          f"microbatches x {n2} steps)")
    for name in ("brick3_encode_fwd", "occ_lookup"):
        check(launches[name] > mb * n2, f"{kind}: {name} launched "
                                        f"{launches[name]}")
    rates = [8192 / s for run_secs in secs for s in run_secs[16:]]
    return {"launches": launches, "system": resumed, "steps": n2,
            "psnr_untrained": psnr0, "psnr_trained": psnr1,
            "psnr_resumed": psnr2, "rays_per_s": float(np.median(rates)),
            "rays_per_s_min": float(min(rates)),
            "rays_per_s_max": float(max(rates))}


def mega_run(root: str, dev) -> tuple:
    """Phase 12c: --model_type mega for DS_SHORT_STEPS steps and one
    validation (finite losses; brick3_table_grad 4 per step)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = []
    system = train_other.main(
        baseline_args(root, "mega", "mega", "--steps_per_epoch",
                      str(DS_SHORT_STEPS), "--num_epochs", "1"),
        device=dev, on_step=lambda step, loss, aux: losses.append(
            float(loss)))
    system.close()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    with open(os.path.join("logs", "TanksAndTemple", "Sphere", "mega",
                           "metrics.jsonl")) as f:
        psnr = [json.loads(line)["value"] for line in f
                if '"test/psnr"' in line]
    print(f"[mega] {len(losses)} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, test PSNR {psnr}; launches {launches}")
    check(len(losses) == DS_SHORT_STEPS and all(np.isfinite(losses))
          and len(psnr) == 1 and np.isfinite(psnr[0]),
          "mega: non-finite losses or no validation")
    mb = tt.TrainConfig().n_microbatch
    check(launches["brick3_table_grad"] == mb * DS_SHORT_STEPS,
          f"mega: brick3_table_grad launched {launches}")
    return launches, {"steps": DS_SHORT_STEPS, "loss_first": losses[0],
                      "loss_last": losses[-1], "psnr": psnr[0]}


def baseline_trainer(kind: str, store: dict, dev):
    """A fresh baseline at full width (scale 0.5, T=2^19, bf16, brick3,
    zoo 2, the script's cv weight) on phase 5's ray store, its grid after
    the warmup update: the state a first step sees."""
    config = SwitchNGPConfig if kind == "switch" else BlockNGPConfig
    cfg = config(scale=0.5, compute_dtype="bfloat16", hash_impl="brick3")
    gen = torch.Generator().manual_seed(1)
    anchors = None
    if kind == "switch":
        params = init_switch_ngp(gen, cfg, device=dev)
    else:
        params = init_block_ngp(gen, cfg, device=dev)
        anchors = torch.from_numpy(kmeans_cameras(
            store["poses"][:, :, 3].cpu().numpy().copy(), 2)).to(dev)
    trainer = tt.Trainer(
        cfg, tt.TrainConfig(cv_loss_w=1e-4), params, None,
        init_ngp_state(cfg, device=dev), store,
        torch.Generator(device=dev).manual_seed(2),
        loss=other_loss_fn(kind, anchors, 0.25),
        density_fn=other_density_fn(kind))
    trainer.update_grid(warmup=True)
    return trainer


def baseline_vs_cpu(kind: str, system, store: dict, dev) -> dict:
    """Phase 12d: the baseline on the card against the CPU: a CHUNK-ray
    test chunk of test view 0 from the resumed system (CPU_TOL), and one
    step-0 microbatch of 2048 rays of a fresh model (TRAIN_CPU_LOSS_RTOL,
    TRAIN_CPU_GRAD_RTOL), its gate noise drawn on the CPU for both sides;
    the switch's CPU side routed as the card's (RouteTap: its flips
    counted, each a near tie, at most 0.1% of the slots); one step
    profiled."""
    ds = system.test_dataset
    w, img_h = ds.img_wh
    p0 = (img_h // 2) * w - CHUNK // 2
    dirs = torch.from_numpy(ds.directions[p0:p0 + CHUNK])
    pose = torch.from_numpy(ds.poses[0])
    rcfg, overlap = system.trainer.rcfg, system.h.overlap_ratio
    tap = RouteTap()
    outs = []
    for d in (dev, "cpu"):
        move = (lambda t: to_cpu(t)) if d == "cpu" else (lambda t: t)
        anchors = None if system.anchors is None else move(system.anchors)
        with tap.record() if d == dev else tap.replay():
            outs.append(render_rays_chunked(
                move(system.params), move(system.model_state), system.cfg,
                None, dirs.to(d), pose.to(d), rcfg, chunk=CHUNK,
                render=baseline_render(kind, move(system.params),
                                       move(system.model_state), system.cfg,
                                       rcfg, anchors, overlap)))
    route = tap.check_ties(f"{kind} render") if kind == "switch" else None
    diffs = {k: float((outs[0][k].cpu() - outs[1][k]).abs().max())
             for k in CPU_TOL}
    print(f"[{kind}] card vs CPU plain, a {CHUNK}-ray test chunk of test "
          f"view 0: max|diff| {diffs} (tolerance {CPU_TOL}); samples "
          f"{outs[0]['total_samples']} vs {outs[1]['total_samples']}"
          + (f"; point gate {route}" if route else ""))
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"{kind} render card vs CPU {k}: {diffs[k]}")
    check(outs[0]["total_samples"] == outs[1]["total_samples"],
          f"{kind} render: card and CPU marched different samples")

    trainer = baseline_trainer(kind, store, dev)
    tcfg = trainer.tcfg
    rays = tcfg.batch_size // tcfg.n_microbatch
    extra, tap = None, None
    if kind == "switch":
        tap = RouteTap()
        budget = trainer.rcfg.budget_per_ray

        def extra(batch, seed):
            g = torch.Generator().manual_seed(seed)
            return {"gate_noise": torch.randn((rays, budget, 2),
                                              generator=g).to(dev)}
    step = train_vs_cpu(trainer, label=kind, rays=rays, batch_extra=extra,
                        route=tap)
    if tap is not None:
        step[0]["route"] = tap.check_ties(f"{kind} step")
    profile = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, tcfg.batch_size)),
        f"one {kind} training step ({tcfg.batch_size} rays, "
        f"{tcfg.n_microbatch} microbatches, budget "
        f"{trainer.rcfg.budget_per_ray})")
    return {"render": diffs, "render_route": route, "step": step,
            "profile": profile}


def baseline_phase(cfg: MNGPConfig, store: dict, dev, smi: str) -> tuple:
    """Phase 12 (see the module docstring). Returns ({path: launch
    counts}, summary)."""
    t_phase = time.perf_counter()
    launches, summary = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
        root = write_tanks_scene(tmp, cfg, dev)
        cwd = os.getcwd()
        os.chdir(tmp)          # logs/, ckpts/, results/ go under tmp
        try:
            for kind in ("switch", "block"):
                t0 = time.perf_counter()
                res = baseline_runs(kind, root, dev)
                launches[kind] = res.pop("launches")
                system = res.pop("system")
                res["vs_cpu"] = baseline_vs_cpu(kind, system, store, dev)
                del system
                res["seconds"] = time.perf_counter() - t0
                summary[kind] = res
                print(f"[{kind}] {res['seconds']:.1f} s; train rays/s "
                      f"median {res['rays_per_s']:.0f} (steps after the "
                      f"first 16 of each run); launches {launches[kind]}; "
                      f"{smi}")
            t0 = time.perf_counter()
            launches["mega"], summary["mega"] = mega_run(root, dev)
            summary["mega"]["seconds"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[baselines] phase 12 in {summary['seconds']:.1f} s (switch "
          f"{summary['switch']['seconds']:.1f} s, block "
          f"{summary['block']['seconds']:.1f} s, mega "
          f"{summary['mega']['seconds']:.1f} s); {smi}")
    return launches, summary


# ---------------------------------------------------------------- phase 10
def sphere_images(poses: np.ndarray, k: np.ndarray, wh: tuple,
                  cfg: MNGPConfig, dev, background: float,
                  size: float = 1.0) -> np.ndarray:
    """render_sphere's views (the sphere scaled by `size`) from (n, 3, 4)
    poses through the pinhole `k` at wh = (w, h), as float32 (n, h, w, 3)
    in [0, 1] on the host."""
    w, h = wh
    store = {"poses": torch.tensor(poses, dtype=torch.float32, device=dev),
             "directions": torch.from_numpy(
                 get_ray_directions(h, w, k)).to(dev)}
    img = render_sphere(store, cfg, background=background,
                        size=size).clamp(0, 1)
    return img.reshape(len(poses), h, w, 3).cpu().numpy()


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def pinhole(w: int, h: int, half_fov_deg: float = 32.0) -> np.ndarray:
    f = w / 2 / np.tan(np.radians(half_fov_deg))
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def homog(c2w: np.ndarray) -> np.ndarray:
    return np.vstack([c2w, [0, 0, 0, 1]])


def write_rgba_png(path: str, img: np.ndarray) -> None:
    """uint8 (H, W, 4) as an 8-bit RGBA PNG (colour type 6, no filter)."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 6, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def nerfpp_scene(parent: str, dev) -> str:
    """rad_tat.sh's layout (NeRF++: {train,test}/rgb/*.png, pose/*.txt,
    train/intrinsics/*.txt) of phase 9's scene scaled to the scale-4 box
    (BOX_SIZE) on black: DS_VIEWS cameras at radius 1.2 x BOX_SIZE (every
    9th a test view), PNGs at 192x144, whose size the loader reads from
    the header."""
    root = os.path.join(parent, "tat_intermediate_M60")
    w, h = 192, 144
    k = pinhole(w, h)
    poses = shell_poses(DS_VIEWS, radius=1.2 * BOX_SIZE)
    imgs = sphere_images(poses, k, (w, h), DS_CFG[4.0], dev, 0.0,
                         size=BOX_SIZE)
    counts = {"train": 0, "test": 0}
    for i, (img, pose) in enumerate(zip(imgs, poses)):
        split = "test" if i % 9 == 4 else "train"
        for sub in ("rgb", "pose"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        name = f"{counts[split]:05d}"
        counts[split] += 1
        write_png(os.path.join(root, split, "rgb", name + ".png"),
                  to_uint8(img))
        np.savetxt(os.path.join(root, split, "pose", name + ".txt"),
                   homog(pose).reshape(1, 16))
    os.makedirs(os.path.join(root, "train", "intrinsics"))
    np.savetxt(os.path.join(root, "train", "intrinsics", "00000.txt"),
               homog(np.pad(k, ((0, 0), (0, 1)))).reshape(1, 16))
    return root


def scannet_scene(parent: str, dev) -> str:
    """rad_scannet.sh's layout (ScanNet: intrinsics.txt for 1296x968,
    poses/*.txt, images/*.jpg with a 24-pixel border) of the sphere at
    half size (radius 0.15) at scale 0.5 on white: SCANNET_VIEWS
    cameras, one pose inf (the loader drops it), placed on a radius-18
    shell so that the loader's cube normalization (camera box + 2 x 2.0)
    brings them to ~0.45 from the sphere's centre, inside the scene box
    as indoor cameras are. Each view is rendered at the training size
    (1296x968 x DS_SCANNET), written at two thirds of it plus the
    border, by the port's JPEG encoder, and resized up by the loader."""
    root = os.path.join(parent, "scene0046")
    os.makedirs(os.path.join(root, "poses"))
    os.makedirs(os.path.join(root, "images"))
    wf, hf = int(1296 * DS_SCANNET), int(968 * DS_SCANNET)
    k_full = pinhole(1296, 968, half_fov_deg=50.0)
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               homog(np.pad(k_full, ((0, 0), (0, 1)))))
    poses = shell_poses(SCANNET_VIEWS, radius=18.0)
    valid = np.ones(len(poses), bool)
    valid[SCANNET_INF] = False
    # the loader's normalization (data/scannet.py), on the valid poses
    norm = poses[valid].copy()
    lo, hi = norm[..., 3].min(0), norm[..., 3].max(0)
    norm[..., 3] -= (lo + hi) / 2
    norm[..., 3] /= (hi - lo).max() + 2 * 2.0
    k = k_full.copy()
    k[:2] *= DS_SCANNET
    imgs = sphere_images(norm, k, (wf, hf), DS_CFG[0.5], dev, 1.0,
                         size=0.5)
    inner = (wf * 2 // 3, hf * 2 // 3)
    j = 0
    for i, pose in enumerate(poses):
        c2w = homog(pose)
        if not valid[i]:
            c2w[:3] = np.inf
        np.savetxt(os.path.join(root, "poses", f"{i:04d}.txt"), c2w)
        small = resize_linear(imgs[j], inner)
        j += int(valid[i])
        write_jpeg(os.path.join(root, "images", f"{i:04d}.jpg"),
                   to_uint8(np.pad(small, ((24, 24), (24, 24), (0, 0)),
                                   mode="edge")), quality=95)
    return root


def eyeful_scene(parent: str, dev) -> str:
    """rad_eyeful.sh's layout (Eyeful Tower: cameras.json KRT,
    splits.json, images/*.jpg) of phase 9's scene scaled to the scale-4
    box (BOX_SIZE) on black: DS_VIEWS cameras at radius 1.2 x BOX_SIZE,
    written at 114x171 (cameras.json's width, so the loader's 684x1024 x
    DS_EYEFUL frame is 1.5x larger) by the port's JPEG encoder, and
    resized up by the loader."""
    root = os.path.join(parent, "apartment")
    os.makedirs(os.path.join(root, "images"))
    wd, hd = 114, 171
    wf, hf = int(684 * DS_EYEFUL), int(1024 * DS_EYEFUL)
    k = pinhole(wf, hf)
    k_disk = k.astype(np.float64).copy()
    k_disk[:2] *= (wd / 684) / DS_EYEFUL       # the loader divides this out
    poses = shell_poses(DS_VIEWS, radius=1.2 * BOX_SIZE)
    imgs = sphere_images(poses, k, (wf, hf), DS_CFG[4.0], dev, 0.0,
                         size=BOX_SIZE)
    krt, split = [], {"train": [], "test": []}
    for i, (img, pose) in enumerate(zip(imgs, poses)):
        cam = f"cam{i:03d}"
        split["test" if i % 9 == 4 else "train"].append(cam)
        krt.append({"cameraId": cam, "width": wd, "height": hd,
                    "K": k_disk.T.tolist(),
                    "T": np.linalg.inv(homog(pose)).T.tolist()})
        write_jpeg(os.path.join(root, "images", cam + ".jpg"),
                   to_uint8(resize_linear(img, (wd, hd))), quality=95)
    with open(os.path.join(root, "cameras.json"), "w") as f:
        json.dump({"KRT": krt}, f)
    with open(os.path.join(root, "splits.json"), "w") as f:
        json.dump(split, f)
    return root


def nerf_scene(parent: str, dev) -> str:
    """A Blender scene (transforms_{train,test}.json, RGBA PNGs at
    200x200 for --downsample 0.25): 14 cameras at radius 4 in the
    OpenGL convention, which the loader flips and brings to radius 1.5;
    the sphere on white, its opacity the alpha."""
    root = os.path.join(parent, "nerf_synthetic", "sphere")
    angle = 2 * np.arctan(0.5 / 0.8)        # focal 0.8 x the width
    poses = shell_poses(14, radius=4.0)
    norm = poses.astype(np.float32).copy()      # data/nerf.py's frame
    norm[:, :, 3] /= (np.linalg.norm(norm[:, :, 3], axis=1) / 1.5)[:, None]
    f = 0.5 * 200 / np.tan(0.5 * angle)
    k = np.array([[f, 0, 100], [0, f, 100], [0, 0, 1]], np.float32)
    white = sphere_images(norm, k, (200, 200), DS_CFG[0.5], dev, 1.0)
    black = sphere_images(norm, k, (200, 200), DS_CFG[0.5], dev, 0.0)
    alpha = np.clip(1.0 - (white - black)[..., :1], 0, 1)
    rgb = np.where(alpha > 0, black / np.maximum(alpha, 1e-6), 1.0)
    for split, idx in (("train", range(12)), ("test", range(12, 14))):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in idx:
            gl = homog(poses[i])
            gl[:3, 1:3] *= -1                  # right down front -> OpenGL
            name = f"{split}/r_{i}"
            write_rgba_png(os.path.join(root, name + ".png"), to_uint8(
                np.concatenate([rgb[i], alpha[i]], axis=-1)))
            frames.append({"file_path": name,
                           "transform_matrix": gl.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)
    return root


def rtmv_scene(parent: str, dev) -> str:
    """An RTMV 'bricks' scene (per-frame *.json, images/*.png): 108
    frames (0-99 train, 105-107 test) of the sphere on white at 48x48,
    the scene box [-1, 1]^3, so that the loader's normalization (box
    centre, x 1 / 2.1) brings the cameras at radius 2.52 to 1.2."""
    root = os.path.join(parent, "rtmv_bricks", "scene")
    os.makedirs(os.path.join(root, "images"))
    k = pinhole(48, 48)
    poses = shell_poses(108)
    imgs = sphere_images(poses, k, (48, 48), DS_CFG[0.5], dev, 1.0)
    for i, (img, pose) in enumerate(zip(imgs, poses)):
        c2w = homog(pose)
        c2w[:3, 3] *= 2.1
        c2w[:3, 1:3] *= -1                      # the loader flips them back
        meta = {"camera_data": {
            "scene_center_3d_box": [0.0, 0.0, 0.0],
            "scene_min_3d_box": [-1.0] * 3, "scene_max_3d_box": [1.0] * 3,
            "intrinsics": {"fx": float(k[0, 0]), "fy": float(k[1, 1]),
                           "cx": 24.0, "cy": 24.0},
            "width": 48, "height": 48, "cam2world": c2w.T.tolist()}}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        write_png(os.path.join(root, "images", f"{i:05d}.png"),
                  to_uint8(img))
    return root


def replica_scene(parent: str, dev) -> str:
    """A Replica scene (transforms.json, images/*.jpg, poses/*.txt): 16
    cameras at radius 1.2 (even ones train, odd ones test), the sphere
    on white at 64x48, JPEGs by the port's encoder."""
    root = os.path.join(parent, "replica", "room0")
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "poses"))
    k = pinhole(64, 48)
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump({"w": 64, "h": 48, "fl_x": float(k[0, 0]),
                   "fl_y": float(k[1, 1])}, f)
    poses = shell_poses(16)
    imgs = sphere_images(poses, k, (64, 48), DS_CFG[0.5], dev, 1.0)
    for i, (img, pose) in enumerate(zip(imgs, poses)):
        write_jpeg(os.path.join(root, "images", f"{i:04d}.jpg"),
                   to_uint8(img), quality=95)
        np.savetxt(os.path.join(root, "poses", f"{i:04d}.txt"), homog(pose))
    return root


def mill19_scene(parent: str, dev) -> str:
    """A Mill19 scene (coordinates.pt, train/metadata/*.pt written with
    torch.save, train/rgbs/*.jpg): 12 cameras whose denormalized centres
    (x 50 + origin_drb) lie at radius 100, which the loader's minimum
    norm brings to 1; the sphere on white at 64x48."""
    root = os.path.join(parent, "mill19", "scene")
    os.makedirs(os.path.join(root, "train", "metadata"))
    os.makedirs(os.path.join(root, "train", "rgbs"))
    origin, psf = np.array([10.0, 20.0, 30.0]), 50.0
    torch.save({"origin_drb": torch.tensor(origin),
                "pose_scale_factor": psf},
               os.path.join(root, "coordinates.pt"))
    k = pinhole(64, 48)
    unit = shell_poses(12, radius=1.0)
    imgs = sphere_images(unit, k, (64, 48), DS_CFG[0.5], dev, 1.0)
    for i, (img, pose) in enumerate(zip(imgs, unit)):
        c2w = pose.copy()
        c2w[:, 3] = (pose[:, 3] * 100.0 - origin) / psf
        torch.save({"W": 64, "H": 48, "intrinsics": torch.tensor(
            [k[0, 0], k[1, 1], 32.0, 24.0]),
            "c2w": torch.tensor(c2w, dtype=torch.float64)},
            os.path.join(root, "train", "metadata", f"{i + 1:06d}.pt"))
        write_jpeg(os.path.join(root, "train", "rgbs", f"{i + 1:06d}.jpg"),
                   to_uint8(img), quality=95)
    return root


# phase 10: dataset_type -> (scene writer, [steps an epoch,] the script's
# options and the phase's cuts); the three full runs train through
# train_ml.main
DS_FULL = {
    "nerfpp": (nerfpp_scene, 64, (
        "--scale", "4", "--downsample", "1", "--cv_loss_w", "1e-2",
        "--depth_mutual_loss_w", "5e-3", "--optimize_ext")),
    "scannet": (scannet_scene, 96, (
        "--scale", "0.5", "--downsample", str(DS_SCANNET), "--cv_loss_w",
        "1e-2", "--depth_mutual_loss_w", "5e-3")),
    "eyeful": (eyeful_scene, 64, (
        "--scale", "4", "--downsample", str(DS_EYEFUL), "--cv_loss_w",
        "1e-2", "--depth_mutual_loss_w", "1e-4")),
}
DS_SHORT = {
    "nerf": (nerf_scene, ("--scale", "0.5", "--downsample", "0.25")),
    "rtmv": (rtmv_scene, ("--scale", "0.5", "--downsample", "1")),
    "replica": (replica_scene, ("--scale", "0.5", "--downsample", "1")),
    "mill19": (mill19_scene, ("--scale", "0.5", "--downsample", "1")),
}


def ds_args(root: str, key: str, exp: str, *extra,
            steps: int = DS_SHORT_STEPS) -> list:
    return ["--root_dir", root, "--dataset_type", key, "--dataset_name",
            key, "--scene_name", "sphere", "--exp_name", exp,
            "--batch_size", "8192", "--lr", "1e-2", "--model_zoo_size", "2",
            "--gate_type", "ray", "--hash_impl", "brick3",
            "--hash_table_size", "19", "--steps_per_epoch", str(steps),
            "--num_epochs", str(DS_EPOCHS), *extra]


def codec_times() -> dict:
    """Host times of the port's JPEG decode of one 1296x968 4:2:0 file
    (a ScanNet frame's size, quality 90) and of resize_linear from the
    ScanNet loader's unpadded 1248x920 to 648x484 (--downsample 0.5)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:968, 0:1296]
    img = np.stack([128 + 100 * np.sin(x / 37.0 + c) * np.cos(y / 23.0 - c)
                    for c in range(3)], -1) + rng.normal(0, 8, (968, 1296, 3))
    data = encode_jpeg(to_uint8(img / 255), quality=90, subsampling="4:2:0")
    t0 = time.perf_counter()
    dec = decode_jpeg(data)
    t_dec = time.perf_counter() - t0
    check(dec.shape == (968, 1296, 3), "JPEG decode shape")
    f = dec[24:-24, 24:-24].astype(np.float32) / 255
    t0 = time.perf_counter()
    small = resize_linear(f, (648, 484))
    t_rs = time.perf_counter() - t0
    check(small.shape == (484, 648, 3) and np.isfinite(small).all(),
          "resize_linear output")
    return {"jpeg_decode_1296x968_s": t_dec, "jpeg_bytes": len(data),
            "resize_1248x920_to_648x484_s": t_rs}


def full_run(key: str, root: str, dev) -> dict:
    """The untrained system validated, then train_ml.main with the
    script's options: DS_EPOCHS epochs of the run's steps, a validation
    and a checkpoint; test PSNR must rise by more than 3 dB."""
    _, spe, opts = DS_FULL[key]
    h = get_opts(ds_args(root, key, "untrained", *opts, "--no_save_test",
                         steps=spe))
    h.moe_training = True
    untrained = tt.NeRFSystem(h, device=dev)
    untrained.setup()
    decoder = untrained.train_dataset.decoder
    n_train = len(untrained.train_dataset.poses)
    n_test = len(untrained.test_dataset.poses)
    wh = untrained.train_dataset.img_wh
    psnr0 = untrained.validate(epoch=0)["psnr"]
    untrained.close()
    del untrained
    secs = []
    system = train_ml.main(ds_args(root, key, "smoke", *opts, steps=spe),
                           device=dev, on_step=step_timer(secs))
    ckpt = load_ckpt(os.path.join("ckpts", key, "sphere", "smoke",
                                  f"epoch={DS_EPOCHS - 1}.ckpt"))
    with open(os.path.join("logs", key, "sphere", "smoke",
                           "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    psnr1 = [m["value"] for m in metrics if m["tag"] == "test/psnr"][-1]
    rec = {"decoder": decoder, "img_wh": list(wh), "train_views": n_train,
           "test_views": n_test, "steps": len(secs),
           "psnr_untrained": psnr0, "psnr_trained": psnr1,
           "rays_per_s": float(np.median([8192 / t for t in secs[16:]]))}
    check(len(secs) == DS_EPOCHS * spe, f"{key}: {len(secs)} steps")
    check(psnr1 > psnr0 + 3.0, f"{key}: test psnr {psnr0} -> {psnr1}")
    if "--optimize_ext" in opts:
        ext = {n: v.detach() for n, v in system.ext_params.items()}
        for name in ("dR", "dT"):
            v = ext[name]
            check(bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0,
                  f"{key}: ext {name} not finite and nonzero")
            check(np.array_equal(ckpt["ext_params"][name], v.cpu().numpy()),
                  f"{key}: the checkpoint's ext_params differ")
        rec["ext_abs_max"] = {n: float(ext[n].abs().max()) for n in ext}
    system.close()
    return rec


def short_run(key: str, root: str, dev) -> dict:
    """NeRFSystem.setup on the train and test splits, DS_SHORT_STEPS
    steps and one validation; the loss must stay finite."""
    h = get_opts(ds_args(root, key, "short", *DS_SHORT[key][1],
                         "--no_save_test"))
    h.moe_training = True
    system = tt.NeRFSystem(h, device=dev)
    system.setup()
    losses = []
    system.trainer.fit_steps(DS_SHORT_STEPS, lambda step, loss, aux:
                             losses.append(float(loss)))
    psnr = system.validate(epoch=0)["psnr"]
    rec = {"decoder": system.train_dataset.decoder,
           "img_wh": list(system.train_dataset.img_wh),
           "train_views": len(system.train_dataset.poses),
           "test_views": len(system.test_dataset.poses),
           "loss_first": losses[0], "loss_last": losses[-1], "psnr": psnr}
    check(len(losses) == DS_SHORT_STEPS and np.isfinite(losses).all(),
          f"{key}: losses {losses}")
    check(psnr is not None and np.isfinite(psnr), f"{key}: psnr {psnr}")
    system.close()
    return rec


def datasets_phase(dev, smi: str) -> tuple:
    """Phase 10: every dataset of the launch scripts (see the module
    docstring). Returns (launch counts of the phase, summary)."""
    t_phase = time.perf_counter()
    summary = {"codec": codec_times(),
               "native": native.unavailable_reason() or "loaded"}
    print(f"[datasets] the native decoder: {summary['native']}")
    print(f"[datasets] host times: JPEG decode 1296x968 4:2:0 "
          f"{summary['codec']['jpeg_decode_1296x968_s']:.3f} s, "
          f"resize_linear 1248x920 -> 648x484 "
          f"{summary['codec']['resize_1248x920_to_648x484_s']:.4f} s")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    steps = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datasets_") as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)          # logs/, ckpts/, results/ go under tmp
        try:
            for key, (writer, *_) in {**DS_FULL, **DS_SHORT}.items():
                t0 = time.perf_counter()
                root = writer(tmp, dev)
                t_write = time.perf_counter() - t0
                run = full_run if key in DS_FULL else short_run
                rec = run(key, root, dev)
                rec["write_s"] = t_write
                rec["seconds"] = time.perf_counter() - t0
                steps += (DS_EPOCHS * DS_FULL[key][1] if key in DS_FULL
                          else DS_SHORT_STEPS)
                summary[key] = rec
                print(f"[datasets] {key}: {json.dumps(rec)}")
        finally:
            os.chdir(cwd)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    want = tt.TrainConfig(batch_size=8192).n_microbatch * steps
    check(launches["brick3_table_grad"] == want,
          f"brick3_table_grad launched {launches['brick3_table_grad']} "
          f"times, expected {want} (4 microbatches x {steps} steps)")
    for name in ("brick3_encode_fwd", "occ_lookup"):
        check(launches[name] > want, f"{name} launched {launches[name]}")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[datasets] {summary['seconds']:.1f} s in all; {steps} steps; "
          f"launches {launches}; {smi}")
    return launches, summary


# ---------------------------------------------------------------- phase 13
def dense_microbatch(trainer) -> dict:
    """One 2048-ray microbatch (draws from seed 7) of a dense-layout MoE
    trainer's parameters and grids: each expert's lattice candidates
    (xyz, dt; its jitter mod(noise + k/K, 1)) and grid, and every slot of
    the experts' (K, N, S) dense rows as xn in [0, 1]^3 (a pad slot's
    point is its ray's origin, clamped into the box), with a random
    output gradient on the valid slots and zero on the pads (as the path
    gives: a pad slot's weight is 0)."""
    cfg, hcfg = trainer.cfg, trainer.cfg.hash
    gen, batch, rays_o, rays_d, t1, t2 = microbatch_rays(trainer)
    dev, state = rays_o.device, trainer.model_state
    mcfg = trainer.rcfg.march(cfg)
    K = cfg.n_experts
    shift = torch.arange(K, dtype=torch.float32, device=dev)[:, None] / K
    noises = torch.remainder(batch["noise"][None, :] + shift, 1.0)
    cands, ts, valid = [], [], []
    for k in range(K):
        _, dt, xyz, _ = _lattice_candidates(rays_o, rays_d, t1, t2, mcfg,
                                            noises[k])
        cands.append((xyz, dt, state["occ"][k]))
        m = march_rays_train(rays_o, rays_d, t1, t2, state["occ"][k], mcfg,
                             noises[k])
        ts.append(m["ts"])
        valid.append(m["valid"])
    ts, valid = torch.stack(ts), torch.stack(valid).reshape(-1)
    x = fma32(ts[..., None], rays_d[None, :, None, :],
              rays_o[None, :, None, :]).reshape(-1, 3)
    xn = ((x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    g = torch.randn((xn.shape[0], 2 * hcfg.n_levels), generator=gen,
                    device=dev)
    return {"cands": cands, "mcfg": mcfg, "xn": xn,
            "g": torch.where(valid[:, None], g, 0.0).contiguous(),
            "n_valid": int(valid.sum())}


def dense_checks(trainer, at: str) -> dict:
    """Kernels 1-3 against their plain versions at one dense microbatch's
    shapes: kernel 2 on each expert's own candidates and grid, kernels 1
    (both table forms: the training call reads the f32 table) and 3 on
    the K x N x S slots. Returns {kernel: [check records]}."""
    b = dense_microbatch(trainer)
    hcfg = trainer.cfg.hash
    table = trainer.bundle["model"]["hash_table"].detach()
    recs = {
        "occ_lookup": [occ_check(xyz, dt, occ, b["mcfg"],
                                 f"{at}, expert {k}")
                       for k, (xyz, dt, occ) in enumerate(b["cands"])],
        "brick3_encode_fwd": [encode_check(
            table, pack_brick3_table(table), b["xn"], hcfg, at, b["n_valid"],
            plain_reps=10)],
        "brick3_table_grad": [table_grad_check(b["xn"], b["g"], hcfg, at,
                                               b["n_valid"])],
    }
    for name, rs in recs.items():
        for rec in rs:
            print_check(name, rec)
    return recs


def dense_entry(root: str, dev) -> dict:
    """train_ml.main with rad_TAT.sh's ZOO=2 options and --layout dense on
    phase 9's scene: the untrained system validated, DENSE_EPOCHS epochs
    of DENSE_STEPS steps (test PSNR up by more than 3 dB); the launch
    counts reset before and read after; the peak device memory of the
    run."""
    run = os.path.join("TanksAndTemple", "Sphere")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    h = get_opts(entry_args(root, "dense_untrained", *DENSE_ARGS))
    h.moe_training = True
    untrained = tt.NeRFSystem(h, device=dev)
    untrained.setup()
    psnr0 = untrained.validate(epoch=0)["psnr"]
    untrained.close()
    del untrained
    secs = []
    torch.cuda.reset_peak_memory_stats()
    system = train_ml.main(entry_args(root, "dense", *DENSE_ARGS,
                                      "--num_epochs", str(DENSE_EPOCHS)),
                           device=dev, on_step=step_timer(secs))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launch_counts)
    check(system.trainer.rcfg.layout == "dense", "the entry point did not "
          "train on the dense layout")
    system.close()
    del system
    with open(os.path.join("logs", run, "dense", "metrics.jsonl")) as f:
        psnr1 = [json.loads(line)["value"] for line in f
                 if '"test/psnr"' in line][-1]
    n = DENSE_EPOCHS * DENSE_STEPS
    mb = tt.TrainConfig(batch_size=h.batch_size).n_microbatch
    check(len(secs) == n, f"{len(secs)} dense steps")
    check(psnr1 > psnr0 + 3.0, f"dense test psnr {psnr0} -> {psnr1}")
    check(launches["brick3_table_grad"] == mb * n,
          f"dense brick3_table_grad launched "
          f"{launches['brick3_table_grad']} times, expected {mb * n}")
    for name in ("brick3_encode_fwd", "occ_lookup"):
        check(launches[name] > mb * n, f"{name} launched {launches[name]}")
    rates = [h.batch_size / t for t in secs[16:]]
    print(f"[dense] train_ml.main --layout dense: {n} steps, test PSNR "
          f"{psnr0:.3f} -> {psnr1:.3f} dB; train rays/s median "
          f"{np.median(rates):.0f} (min {min(rates):.0f}, max "
          f"{max(rates):.0f}, steps after the first 16); peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    return {"launches": launches, "steps": n, "psnr_untrained": psnr0,
            "psnr_trained": psnr1, "rays_per_s": float(np.median(rates)),
            "rays_per_s_min": float(min(rates)),
            "rays_per_s_max": float(max(rates)),
            "peak_memory_gib": peak / 2**30}


def dense_renders(scene: dict) -> dict:
    """Phase 4's field (expert 0 as a single field, on its own grid) on
    the dense test layout: render_test and render_test_compacted over the
    400x400 image (rays/s, once each after a warm-up chunk), and one
    CHUNK-ray chunk of each on the card and on the CPU (CPU_TOL, the same
    samples)."""
    cfg, rcfg, params, state, directions, pose = (
        scene[k] for k in ("cfg", "rcfg", "params", "state", "directions",
                           "pose"))
    rcfg_d = dataclasses.replace(rcfg, test_layout="dense")
    n_pix = directions.shape[0]

    def renders(p, st):
        fwd = expert_forward_fn(
            p["hash_table"], slice_stacked(p["geo"], 0),
            slice_stacked(p["rgb"], 0), st, cfg,
            packed=pack_for_encode(p, cfg))
        st0 = {**st, "occ": st["occ"][0].contiguous()}
        return {
            "render_test": lambda ro, rd: render_test(
                None, st0, cfg, ro, rd, rcfg_d, forward_fn=fwd),
            "render_test_compacted": lambda ro, rd: render_test_compacted(
                None, st0, cfg, ro, rd, rcfg_d, forward_fn=fwd)}

    card = renders(params, state)
    cpu = renders(to_cpu(params), to_cpu(state))
    c0 = (n_pix // 2 // CHUNK) * CHUNK
    out = {}
    for name, render in card.items():
        render_rays_chunked(params, state, cfg, None, directions[:CHUNK],
                            pose, rcfg_d, chunk=CHUNK, render=render)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_rays_chunked(params, state, cfg, None, directions,
                                  pose, rcfg_d, chunk=CHUNK, render=render)
        torch.cuda.synchronize()
        rate = n_pix / (time.perf_counter() - t0)
        check(bool(torch.isfinite(img["rgb"]).all())
              and float((img["opacity"] > 0.01).float().mean()) > 0,
              f"dense {name}: empty or non-finite image")
        dirs = directions[c0:c0 + CHUNK]
        gpu = render_rays_chunked(params, state, cfg, None, dirs, pose,
                                  rcfg_d, chunk=CHUNK, render=render)
        ref = render_rays_chunked(to_cpu(params), to_cpu(state), cfg, None,
                                  dirs.cpu(), pose.cpu(), rcfg_d,
                                  chunk=CHUNK, render=cpu[name])
        diffs = {k: float((gpu[k].cpu() - ref[k]).abs().max())
                 for k in CPU_TOL}
        print(f"[dense] {name} on the dense test layout: {SIDE}x{SIDE} "
              f"image {rate:.0f} rays/s ({img['iterations']} loop "
              f"iterations, {img['total_samples']} samples); card vs CPU "
              f"on {CHUNK} rays max|diff| {diffs} (tolerance {CPU_TOL}); "
              f"samples {gpu['total_samples']} vs {ref['total_samples']}")
        for k, tol in CPU_TOL.items():
            check(diffs[k] <= tol, f"dense {name} card vs CPU {k}: "
                                   f"{diffs[k]} > {tol}")
        check(gpu["total_samples"] == ref["total_samples"],
              f"dense {name}: card and CPU marched different samples")
        out[name] = {"rays_per_s": rate, "vs_cpu": diffs,
                     "iterations": img["iterations"]}
    return out


def dense_baselines(root: str, dev) -> tuple:
    """DS_SHORT_STEPS steps of switch and block through train_other.main
    with --layout dense and one validation each: finite losses and PSNR.
    Returns (launch counts of both runs, summary)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = {}
    for kind in ("switch", "block"):
        losses = []
        system = train_other.main(
            baseline_args(root, kind, f"{kind}_dense", "--layout", "dense",
                          "--num_epochs", "1", "--steps_per_epoch",
                          str(DS_SHORT_STEPS)),
            device=dev, on_step=lambda s, loss, aux: losses.append(
                float(loss)))
        check(system.trainer.rcfg.layout == "dense",
              f"{kind} did not train on the dense layout")
        system.close()
        del system
        with open(os.path.join("logs", "TanksAndTemple", "Sphere",
                               f"{kind}_dense", "metrics.jsonl")) as f:
            psnr = [json.loads(line)["value"] for line in f
                    if '"test/psnr"' in line]
        check(len(losses) == DS_SHORT_STEPS and all(np.isfinite(losses))
              and len(psnr) == 1 and np.isfinite(psnr[0]),
              f"{kind} --layout dense: losses {losses}, test psnr {psnr}")
        out[kind] = {"loss_first": losses[0], "loss_last": losses[-1],
                     "psnr": psnr[0]}
        print(f"[dense] {kind} --layout dense: {DS_SHORT_STEPS} steps, "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, test PSNR "
              f"{psnr[0]:.3f} dB")
    torch.cuda.synchronize()
    return dict(kernels.launch_counts), out


def dense_phase(scene: dict, store: dict, dev, smi: str) -> tuple:
    """Phase 13 (see the module docstring). Returns ({kernel: check
    records at the dense shapes}, {path: launch counts}, summary)."""
    t_phase = time.perf_counter()
    cfg = scene["cfg"]
    trainer = new_trainer(cfg, store, dev, layout="dense")
    trainer.update_grid(warmup=True)        # the state a first step sees
    checks = dense_checks(trainer, "dense train step 0 (samples_per_ray "
                                   f"{trainer.rcfg.samples_per_ray})")
    trainer.model_state = init_mngp_state(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    launches_t, summary_t = fit(trainer, DENSE_FIT_STEPS, "dense")
    peak = torch.cuda.max_memory_allocated()
    print(f"[dense] peak device memory over {DENSE_FIT_STEPS} dense steps "
          f"of 8192 rays: "
          f"{peak / 2**30:.2f} GiB")
    profile = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, trainer.tcfg.batch_size)),
        f"one dense training step ({trainer.tcfg.batch_size} rays, "
        f"{trainer.tcfg.n_microbatch} microbatches, samples_per_ray "
        f"{trainer.rcfg.samples_per_ray})")
    summary = {"trainer": {**summary_t, "peak_memory_gib": peak / 2**30,
                           "profile": profile},
               "vs_cpu": train_vs_cpu(trainer, label="dense",
                                      pin_gate=True)}
    del trainer
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dense_") as tmp:
        root = write_tanks_scene(tmp, cfg, dev)
        cwd = os.getcwd()
        os.chdir(tmp)          # logs/, ckpts/, results/ go under tmp
        try:
            entry = dense_entry(root, dev)
            launches["dense"] = entry.pop("launches")
            summary["entry"] = entry
            summary["renders"] = dense_renders(scene)
            launches["dense_baselines"], summary["baselines"] = (
                dense_baselines(root, dev))
        finally:
            os.chdir(cwd)
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"[dense] phase 13 in {summary['seconds']:.1f} s; launches "
          f"{launches}; {smi}")
    return checks, launches, summary


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); nothing was run")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build(ptxas_info=True)
    print(f"[build] {len(built)} sources ({len(kernels.KERNELS)} kernels) "
          f"in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, (sec, log) in built.items():
        print(f"[build] {name}: {sec:.1f} s")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"[build]   {line.strip()}")

    scene = render_scene(dev)
    cfg, rcfg, params, gate, state, directions, pose = (
        scene[k] for k in ("cfg", "rcfg", "params", "gate", "state",
                           "directions", "pose"))
    hcfg = cfg.hash
    n_pix = directions.shape[0]

    # 3. kernels vs plain, on the first iteration of the middle chunk
    it = render_iteration(scene)
    c0 = it["c0"]
    at = "render iteration 0"
    table = params["hash_table"]
    render_checks = {
        "occ_lookup": occ_check(it["xyz"], it["dt"], it["occ_union"],
                                it["mcfg"], at),
        "brick3_encode_fwd": encode_check(
            table, pack_brick3_table(table), it["xn"], hcfg, at,
            it["n_valid"]),
    }
    for name, rec in render_checks.items():
        print_check(name, rec)

    # 4. the slice at full width (one chunk first: allocator/cuBLAS warm-up)
    render_rays_chunked(params, state, cfg, gate, directions[:CHUNK], pose,
                        rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = render_rays_chunked(params, state, cfg, gate, directions, pose,
                              rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launches = dict(kernels.launch_counts)
    for _ in range(RENDER_REPEATS - 1):      # the spread of the same render
        t0 = time.perf_counter()
        render_rays_chunked(params, state, cfg, gate, directions, pose, rcfg,
                            chunk=CHUNK)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    rates = [n_pix / s for s in secs]
    print(f"[render] {SIDE}x{SIDE} = {n_pix} rays: median "
          f"{float(np.median(rates)):.0f} rays/s over {len(rates)} renders "
          f"({', '.join(f'{r:.0f}' for r in rates)}); {out['iterations']} "
          f"loop iterations over {-(-n_pix // CHUNK)} chunks; "
          f"{out['total_samples']} samples; launches {launches} (first "
          f"render)")
    for name in ("occ_lookup", "brick3_encode_fwd"):
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "render")
    for key in ("rgb", "depth", "opacity"):
        check(bool(torch.isfinite(out[key]).all()), f"non-finite {key}")
    check(out["rgb"].shape == (n_pix, 3) and out["depth"].shape == (n_pix,),
          "output shapes")
    op = out["opacity"]
    check(bool(((op >= 0) & (op <= 1)).all()), "opacity outside [0, 1]")
    covered = float((op > 0.01).float().mean())
    check(covered > 0, "empty image")
    print(f"[render] covered share {covered:.4f}, mean opacity "
          f"{float(op.mean()):.4f}, rgb range [{float(out['rgb'].min()):.4f},"
          f" {float(out['rgb'].max()):.4f}]")
    profile_call(lambda: render_rays_chunked(
        params, state, cfg, gate, directions[c0:c0 + CHUNK], pose, rcfg,
        chunk=CHUNK))

    # the centre row's middle 256 pixels, on the card and on the CPU
    p0 = (SIDE // 2) * SIDE + (SIDE - CPU_RAYS) // 2
    dirs = directions[p0:p0 + CPU_RAYS]
    gpu = render_rays_chunked(params, state, cfg, gate, dirs, pose, rcfg,
                              chunk=CPU_RAYS)
    cpu = render_rays_chunked(to_cpu(params), to_cpu(state), cfg,
                              to_cpu(gate), dirs.cpu(), pose.cpu(), rcfg,
                              chunk=CPU_RAYS)
    diffs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in CPU_TOL}
    print(f"[render] card vs CPU plain on {CPU_RAYS} rays: max|diff| "
          f"{diffs} (tolerance {CPU_TOL}); samples {gpu['total_samples']} "
          f"vs {cpu['total_samples']}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"card vs CPU {k}: {diffs[k]} > {tol}")
    check(gpu["total_samples"] == cpu["total_samples"],
          "card and CPU marched different samples")

    # the same 256 rays with hash_impl 'dedup': the tcnn-hash forward in
    # PyTorch, no brick3 table packed and no brick3 kernel launched
    cfg_d = dataclasses.replace(cfg, hash_impl="dedup")
    kernels.reset_launch_counts()
    gpu = render_rays_chunked(params, state, cfg_d, gate, dirs, pose, rcfg,
                              chunk=CPU_RAYS)
    torch.cuda.synchronize()
    dedup_render_launches = dict(kernels.launch_counts)
    cpu = render_rays_chunked(to_cpu(params), to_cpu(state), cfg_d,
                              to_cpu(gate), dirs.cpu(), pose.cpu(), rcfg,
                              chunk=CPU_RAYS)
    diffs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in CPU_TOL}
    print(f"[render] dedup family, card vs CPU plain on {CPU_RAYS} rays: "
          f"max|diff| {diffs} (tolerance {CPU_TOL}); samples "
          f"{gpu['total_samples']} vs {cpu['total_samples']}; launches "
          f"{dedup_render_launches}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"dedup render card vs CPU {k}: {diffs[k]}")
    check(gpu["total_samples"] == cpu["total_samples"],
          "dedup render: card and CPU marched different samples")
    check(dedup_render_launches["brick3_encode_fwd"] == 0
          and dedup_render_launches["occ_lookup"] > 0,
          "dedup render launched a brick3 kernel")

    # 5. the training slice at full width
    store = ray_store(cfg, dev)
    train_checks, train_launches, summary = train_phase(cfg, store, dev)
    print(json.dumps({"train": summary}))
    phase_launches = {"render": launches, "train_brick3": train_launches}

    # 6. the dedup family, and one float32 step
    trainer_d, phase_launches["train_dedup"], summary_d = family_phase(
        dataclasses.replace(cfg, hash_impl="dedup"), store, dev,
        DEDUP_STEPS, "dedup", profile=True, pin_forward=True)
    check(summary_d["psnr_last"] > summary_d["psnr_first"] + 3.0,
          f"dedup psnr did not rise: {summary_d}")
    train_vs_cpu(trainer_d, dataclasses.replace(
        cfg, compute_dtype="float32", hash_impl="brick3"),
        TRAIN_CPU_F32_LOSS_RTOL, TRAIN_CPU_F32_GRAD_RTOL, label="float32")
    del trainer_d
    print(json.dumps({"train_dedup": summary_d}))

    # 7. short runs of the slab, brick and pallas families
    for impl in ("slab", "brick", "pallas"):
        _, phase_launches[f"train_{impl}"], summary_f = family_phase(
            dataclasses.replace(cfg, hash_impl=impl), store, dev,
            FAMILY_STEPS, impl)
        print(json.dumps({f"train_{impl}": summary_f}))

    # 8. the examples' gather and scatter kernels, and the step's profile
    example_checks, phase_launches["examples"], profile_ms = examples_phase(
        dev)
    print(json.dumps({"profile_step_ms": profile_ms}))

    # 9. the train_ml.py entry point on a scene on disk
    phase_launches["entry"], summary_e = entry_phase(cfg, dev, smi)
    print(json.dumps({"entry": summary_e}))

    # 10. every dataset of the launch scripts, read back from disk
    phase_launches["datasets"], summary_ds = datasets_phase(dev, smi)
    print(json.dumps({"datasets": summary_ds}))

    # 11. the single field (train.py's entry point), the per-expert and
    # unshared MoE renders, and smoke_e2e
    launches_11, summary_11 = single_phase(cfg, store, dev, smi)
    phase_launches.update(launches_11)
    print(json.dumps({"single_and_experts": summary_11}))

    # 12. train_other.py's baselines: switch, block and mega
    launches_12, summary_12 = baseline_phase(cfg, store, dev, smi)
    phase_launches.update(launches_12)
    print(json.dumps({"baselines": summary_12}))

    # 13. the dense layout: its kernels at the dense shapes, the entry
    # point, card vs CPU, the dense test renders, the baselines
    dense_k, launches_13, summary_13 = dense_phase(scene, store, dev, smi)
    phase_launches.update(launches_13)
    for key, recs in dense_k.items():
        train_checks[key] += recs
    print(json.dumps({"dense": summary_13}))

    # 14. kernels line: per kernel and contract, the launches of the path
    # that runs it (its training phase, or the examples'; every phase's
    # counts, the entry point's among them, under launches_by_path); ms, plain, library and bound at a
    # training step 0 microbatch, the shape of most launches (the
    # examples' kernels: at their scripts' default size); max_abs_err the
    # worst of every check, all in "checks"
    rows = [
        # (check key, kernel, source, replaced Pallas kernel, the wrapper
        # whose contract it keeps, main path)
        ("occ_lookup", "occ_lookup", "occ_lookup.cu",
         "radnerf_tpu/ops/marching.py:312", "occupancy_lookup_bricks",
         "train_brick3"),
        ("brick3_encode_fwd", "brick3_encode_fwd", "brick3_encode_fwd.cu",
         "radnerf_tpu/ops/hashgrid_brick3.py:257",
         "hashgrid_encode_brick3_fwd_impl", "train_brick3"),
        ("brick3_table_grad", "brick3_table_grad", "brick3_table_grad.cu",
         "radnerf_tpu/ops/hashgrid_brick3.py:493",
         "hashgrid_table_grad_brick3", "train_brick3"),
        ("hashgrid_table_grad_window", "tcnn_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_window.py:57",
         "sorted_table_grad_window", "train_dedup"),
        ("sorted_table_grad_window_pair", "slab_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_window.py:244",
         "sorted_table_grad_window_pair", "train_slab"),
        ("sorted_table_grad_brick", "brick_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_brick.py:264",
         "sorted_table_grad_brick", "train_brick"),
        ("hashgrid_table_grad", "tcnn_table_grad", "stream_table_grad.cu",
         "radnerf_tpu/ops/hashgrid_pallas.py:41", "hashgrid_table_grad",
         "train_pallas"),
        ("tal_sublane", "tal_sublane", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:54", "tal_sublane", "examples"),
        ("rowgather_onehot", "rowgather_onehot", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:72", "rowgather_onehot",
         "examples"),
        ("tal_sublane_l2", "tal_sublane_l2", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:54", "tal_sublane", "examples"),
        ("pallas_gather", "pallas_gather", "proto_gather.cu",
         "examples/proto_pallas_gather.py:52", "pallas_gather", "examples"),
        ("pallas_scatter", "pallas_scatter", "proto_gather.cu",
         "examples/proto_pallas_gather.py:84", "pallas_scatter",
         "examples"),
    ]
    recs = []
    for key, name, source, replaces, contract, path in rows:
        n_launch = phase_launches[path][name]
        check(n_launch > 0, f"kernel {name} not launched on {path}")
        if path == "train_brick3":       # rows 1-3: the entry points' too
            for entry in ("entry", "datasets", "single", "per_expert",
                          "unshared", "switch", "block", "mega", "dense",
                          "dense_baselines"):
                check(phase_launches[entry][name] > 0,
                      f"kernel {name} not launched on {entry}")
        runs = train_checks.get(key, []) + [
            checks[key] for checks in (render_checks, example_checks)
            if key in checks]
        main_rec = runs[0]
        recs.append({
            "name": name, "route": "cuda",
            "source": f"radnerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "contract": contract,
            "launches": n_launch, "main_path": path,
            "launches_by_path": {p: c[name]
                                 for p, c in phase_launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            **{k: main_rec[k] for k in ("shape", "form", "ms", "device_ms",
                                        "plain_ms", "library_ms",
                                        "library_device_ms", "bound_ms",
                                        "bound_by", "train_path_device_ms",
                                        "train_path_bound_ms",
                                        "pack_device_ms")
               if k in main_rec},
            "checks": runs, "ok": True,
        })
    print(f"[done] {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
