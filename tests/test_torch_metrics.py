"""The port's image metrics against the JAX package's on the same
seeded image pairs: SSIM (the 11x11 gaussian window, sigma 1.5) and PSNR
within 1e-5; LPIPS raises ImportError where torchmetrics is missing."""

import importlib.util

import numpy as np
import pytest
import torch

from radnerf_tpu import metrics as jm
from radnerf_tpu_torch import metrics as tm


@pytest.mark.parametrize("shape", [(32, 32, 3), (108, 192, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_psnr_equal_jax(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    # a correlated pair: b is a noisy, blurred-ish copy of a
    b = np.clip(0.7 * a + 0.3 * np.roll(a, 1, axis=1)
                + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tm.ssim(ta, tb)) - float(jm.ssim(a, b))) <= 1e-5
    assert abs(float(tm.psnr(ta, tb)) - float(jm.psnr(a, b))) <= 1e-5
    assert abs(float(tm.ssim(ta, ta)) - 1.0) <= 1e-5


def test_lpips_raises_importerror_without_torchmetrics():
    if importlib.util.find_spec("torchmetrics") is not None:
        pytest.skip("torchmetrics is installed here")
    x = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(ImportError):
        tm.lpips_vgg(x, x)
