"""Dataset base class (twin of radnerf_tpu/data/base.py, the reference's
datasets/base.py): the fields every loader sets. A training "epoch" is
1000 virtual batches (base.py:19-21); the trainer keeps the whole ray
store on its device and draws the batches there.
"""

from __future__ import annotations

import numpy as np


class BaseDataset:
    """Subclasses must set: poses (M, 3, 4) f32, directions (H*W, 3) f32,
    rays (M, H*W, C) f32 (rgb [+extras]), img_wh (W, H), K (3, 3), and
    `decoder`, the name of the decoder that read the images."""

    STEPS_PER_EPOCH = 1000  # base.py:19-21

    def __init__(self, root_dir: str, split: str = "train",
                 downsample: float = 1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.rays = np.zeros((0, 0, 3), np.float32)
        self.decoder = None
