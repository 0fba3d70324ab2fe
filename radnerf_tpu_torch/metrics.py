"""Image metrics (twin of radnerf_tpu/metrics.py): PSNR, SSIM, and LPIPS
where torchmetrics and its VGG weights are installed."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(image_pred, image_gt, valid_mask=None):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    return value.mean()


def psnr(image_pred, image_gt, valid_mask=None, data_range: float = 1.0):
    return -10.0 * torch.log10(
        mse(image_pred, image_gt, valid_mask) / data_range**2
    )


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(
    img0: torch.Tensor,
    img1: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair (gaussian-windowed, matching
    torchmetrics' defaults: 11x11 window, sigma 1.5, valid positions
    only)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel(kernel_size, sigma).to(img0.device)[None, None]

    def filt(x):  # (H, W, C) -> (H', W', C), a per-channel gaussian filter
        y = F.conv2d(x.permute(2, 0, 1)[:, None], kern)
        return y[:, 0].permute(1, 2, 0)

    mu0, mu1 = filt(img0), filt(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = filt(img0 * img0) - mu00
    s11 = filt(img1 * img1) - mu11
    s01 = filt(img0 * img1) - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return (num / den).mean()


def lpips_vgg(img0, img1):
    """LPIPS (vgg) of an (H, W, 3) pair in [0, 1] through torchmetrics
    (`--eval_lpips`). Raises ImportError where torchmetrics is missing."""
    from torchmetrics.image.lpip import (
        LearnedPerceptualImagePatchSimilarity,
    )

    metric = getattr(lpips_vgg, "_metric", None)
    if metric is None:
        metric = LearnedPerceptualImagePatchSimilarity("vgg")
        lpips_vgg._metric = metric

    def prep(x):
        t = torch.as_tensor(x, dtype=torch.float32).cpu()
        return torch.clip(t.permute(2, 0, 1)[None] * 2 - 1, -1, 1)

    with torch.no_grad():
        return float(metric(prep(img0), prep(img1)))
