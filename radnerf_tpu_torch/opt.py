"""Command-line flags (twin of radnerf_tpu/opt.py: the same 62 flags, names
and defaults, so that the reference's shell scripts translate
mechanically). --num_devices and --multihost build the data-parallel
mesh of the training entry points (parallel/), as in the reference.
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    # dataset parameters
    parser.add_argument('--root_dir', type=str, required=True,
                        help='root directory of dataset')
    parser.add_argument('--dataset_type', type=str, default='nsvf',
                        help='which dataset type to load')
    parser.add_argument('--dataset_name', type=str, default='llff',
                        help='which dataset to train/test')
    parser.add_argument('--scene_name', type=str, default='fern',
                        help='which specified scene of the dataset to train/test')
    parser.add_argument('--split', type=str, default='train',
                        choices=['train', 'trainval', 'trainvaltest'],
                        help='use which split to train')
    parser.add_argument('--downsample', type=float, default=1.0,
                        help='downsample factor (<=1.0) for the images')

    # model parameters
    parser.add_argument('--scale', type=float, default=1,
                        help='scene scale (whole scene must lie in [-scale, scale]^3')
    parser.add_argument('--hash_table_size', type=int, default=19,
                        help='T of NGP')

    # loss parameters
    parser.add_argument('--opacity_loss_w', type=float, default=1e-3,
                        help='weight of opacity loss, 0 to disable')
    parser.add_argument('--distortion_loss_w', type=float, default=0,
                        help='weight of distortion loss, 0 to disable')
    parser.add_argument('--disp_loss_w', type=float, default=0,
                        help='weight of disparity loss (no render returns '
                             'a disparity, so it has no effect, as in the '
                             'reference)')

    # training options
    parser.add_argument('--batch_size', type=int, default=8192,
                        help='number of rays in a batch')
    parser.add_argument('--ray_sampling_strategy', type=str, default='pixel',
                        choices=['pixel', 'patch'],
                        help='pixel: uniform over all pixels of ALL images; '
                             'patch: uniform over patches')
    parser.add_argument('--patch_size', type=int, default=16,
                        help='size of patch image(16*16)')
    parser.add_argument('--num_epochs', type=int, default=30,
                        help='number of training epochs')
    parser.add_argument('--warmup_steps', type=int, default=256,
                        help='the iterations of warmup training')
    parser.add_argument('--num_gpus', type=int, default=1,
                        help='kept for script parity; see --num_devices')
    parser.add_argument('--num_view', type=int, default=0,
                        help='few-shot training setting (0 = full-shot)')
    parser.add_argument('--gpu_id', type=int, default=0,
                        help='kept for script parity')
    parser.add_argument('--lr', type=float, default=1e-2,
                        help='learning rate')

    # experimental training options
    parser.add_argument('--optimize_ext', action='store_true', default=False,
                        help='whether to optimize extrinsics (per-image '
                             'pose corrections with their own Adam at 1e-8)')
    parser.add_argument('--random_bg', action='store_true', default=False,
                        help='train with random bg color (real scenes)')

    # depth priors options (accepted for script parity; unused, as in the
    # reference's entry points)
    parser.add_argument("--depth_N_rand", type=int, default=4)
    parser.add_argument("--depth_N_iters", type=int, default=201)
    parser.add_argument("--depth_H", type=int, default=480)
    parser.add_argument("--depth_W", type=int, default=640)
    parser.add_argument("--depth_lrate", type=float, default=4e-4)
    parser.add_argument("--depth_i_weights", type=int, default=100)
    parser.add_argument("--depth_i_print", type=int, default=20)
    parser.add_argument('--depth_loss_w', type=float, default=0)

    # moe training options
    parser.add_argument('--moe_training', action='store_true', default=False,
                        help='whether to apply moe training')
    parser.add_argument("--model_zoo_size", type=int, default=5,
                        help='the number of models')
    parser.add_argument('--gate_type', type=str, default='ray',
                        help='the type of gating net (ray | image | position)')
    parser.add_argument('--model_type', type=str, default='switch',
                        help='model type for the other-baseline entry '
                             '(switch | block | mega)')
    parser.add_argument('--diversity_loss_w', type=float, default=0)
    parser.add_argument('--cv_loss_w', type=float, default=0)
    parser.add_argument('--depth_mutual_loss_w', type=float, default=0)
    parser.add_argument('--overlap_ratio', type=float, default=0.25)

    # moe distillation options
    parser.add_argument('--t_ckpt_path', type=str, default=None)
    parser.add_argument('--feat_loss_w', type=float, default=0)

    # validation options
    parser.add_argument('--eval_lpips', action='store_true', default=False)
    parser.add_argument('--val_only', action='store_true', default=False)
    parser.add_argument('--no_save_test', action='store_true', default=False)

    # misc
    parser.add_argument('--exp_name', type=str, default='base')
    parser.add_argument('--ckpt_path', type=str, default=None,
                        help='checkpoint to resume from (params + opt state)')
    parser.add_argument('--resume', type=str, default=None,
                        choices=['auto'],
                        help="'auto': continue from the newest loadable "
                             'checkpoint in the experiment ckpt dir (fresh '
                             'start when none exists); an explicit '
                             '--ckpt_path wins')
    parser.add_argument('--weight_path', type=str, default=None,
                        help='weights to warm-start from (params only)')

    # ---- device options (the reference package's runtime knobs) ----
    dev = parser.add_argument_group('device options')
    dev.add_argument('--num_devices', type=int, default=0,
                     help='devices in the ray-parallel mesh (0 = all '
                          'local): one rank each, started by the entry '
                          'point (on the CPU: that many gloo ranks)')
    dev.add_argument('--samples_per_ray', type=int, default=192,
                     help='static per-ray occupied-sample budget S')
    dev.add_argument('--layout', type=str, default='flat',
                     choices=['flat', 'dense'],
                     help='training sample layout: flat = compacted '
                          'buffer, dense = (N, S) per-ray grid')
    dev.add_argument('--budget_per_ray', type=int, default=64,
                     help='flat layout: average per-ray sample budget '
                          '(total buffer B = batch * budget)')
    dev.add_argument('--compute_dtype', type=str, default='bfloat16',
                     choices=['float32', 'bfloat16'],
                     help='MLP/hash-gather compute dtype (params stay fp32)')
    dev.add_argument('--hash_impl', type=str, default='auto',
                     choices=['auto', 'xla', 'pallas', 'sort', 'window',
                              'dedup', 'slab', 'slab_plain', 'brick',
                              'brick3', 'brick3_plain'],
                     help='hash-grid encode backend (ops/hashgrid.py '
                          'encode_dispatch); checkpoints are tied to the '
                          'impl family that trained them')
    dev.add_argument('--val_chunk', type=int, default=4096,
                     help='rays per test-time render chunk')
    dev.add_argument('--adaptive_budget',
                     action=argparse.BooleanOptionalAction, default=True,
                     help='re-pick the flat-layout sample budget bucket '
                          'from measured buffer utilization at grid-update '
                          'boundaries. Default on; --no-adaptive_budget '
                          'pins the static --budget_per_ray')
    dev.add_argument('--microbatch', type=int, default=0,
                     help='gradient-accumulation slices per ray batch '
                          '(identical expected gradient, lower peak '
                          'memory). 0 = AUTO: one slice per 2048 rays; '
                          '1 forces single-pass')
    dev.add_argument('--multihost', action='store_true', default=False,
                     help='join a multi-host job before building the '
                          'mesh: a launcher (torchrun) starts one process '
                          'per card and sets MASTER_ADDR, MASTER_PORT, '
                          'RANK, WORLD_SIZE and LOCAL_RANK')
    dev.add_argument('--ckpt_backend', type=str, default='pickle',
                     choices=['pickle', 'orbax'],
                     help='how full checkpoints are written: pickle, '
                          'in the training loop; orbax, the same single-'
                          'file pickle at the same path written by a '
                          'background thread (values copied to the host '
                          'first, one write in flight; the slim export, '
                          'the next save and the end of the run wait for '
                          'it). The port has no orbax: it writes and '
                          'reads no orbax directory')
    dev.add_argument('--profile_steps', type=int, default=0,
                     help='capture a profiler trace for this many steps '
                          '(starting at step 10) into the log dir '
                          '(trace/trace.json). It carries the program\'s '
                          'spans (utils/trace.py) as user_annotation '
                          'events: train.step, train.grid_update, '
                          'train.batch, step.slice, step.backward, '
                          'step.allreduce, step.adam, render.gate, '
                          'render.march, render.encode, render.mlp, '
                          'render.composite, loss, test.chunk, '
                          'test.iteration and sync.<site> around each '
                          'wait on the device; while it records, every '
                          'host sync counts as counter `sync`, and each '
                          'kernel launch always counts as `launch.<kernel>`')
    dev.add_argument('--host_sampling', action='store_true', default=False,
                     help='accepted and has no effect, as in the JAX '
                          'package, which declares it and reads it nowhere: '
                          'the ray store always stays on the device')
    dev.add_argument('--seed', type=int, default=1337)
    dev.add_argument('--steps_per_epoch', type=int, default=0,
                     help='override the 1000 virtual steps/epoch '
                          '(datasets/base.py:19-21); 0 = reference default')
    return parser


def get_opts(args=None):
    return get_parser().parse_args(args)
