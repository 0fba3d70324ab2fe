"""Image metrics (twin of radnerf_tpu/metrics.py): PSNR."""

from __future__ import annotations

import torch


def mse(image_pred, image_gt, valid_mask=None):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    return value.mean()


def psnr(image_pred, image_gt, valid_mask=None, data_range: float = 1.0):
    return -10.0 * torch.log10(
        mse(image_pred, image_gt, valid_mask) / data_range**2
    )
