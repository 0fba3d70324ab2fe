"""PFM depth-map reader (twin of radnerf_tpu/data/depth_utils.py, the
reference's datasets/depth_utils.py; used by the depth-prior options,
which are plumbed but unused in the reference's shipped entry points)."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """Returns (data, scale) from a PFM file."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file: " + path)
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        data = np.flipud(data)
        return data, scale
