"""Observability: a file + console logger and a metric writer (twin of
radnerf_tpu/utils/logging.py).

Metric names match the reference's (`train/loss`, `train/psnr`,
`train/rays_per_s`, `test/psnr`, `test/ssim`, `test/lpips_vgg`, `lr`).
Every scalar goes to `metrics.jsonl` in the log dir, and to TensorBoard
where tensorboard is installed.
"""

from __future__ import annotations

import json
import logging
import os

LOGGER_NAME = "radnerf_tpu_torch"


def init_global_logger(log_path: str) -> logging.Logger:
    """The package's logger, writing to `log_path` and the console (the
    handlers of an earlier call are closed and replaced)."""
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricWriter:
    """Scalars to `<log_dir>/metrics.jsonl` (one JSON object a line: tag,
    value, step), and to TensorBoard where it is installed."""

    def __init__(self, log_dir: str):
        self.logdir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": step})
            + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
