"""Observability: a file + console logger and a metric writer (twin of
radnerf_tpu/utils/logging.py).

Metric names match the reference's (`train/loss`, `train/psnr`,
`train/rays_per_s`, `test/psnr`, `test/ssim`, `test/lpips_vgg`, `lr`).
Every scalar goes to `metrics.jsonl` in the log dir, and to TensorBoard
where tensorboard is installed: the operators' record of a run. The
program's spans and counters (layer boundaries on the profiler's clock,
host syncs, kernel launches) are in `utils/trace.py`.
"""

from __future__ import annotations

import json
import logging
import os

LOGGER_NAME = "radnerf_tpu_torch"


def init_global_logger(log_path: str | None) -> logging.Logger:
    """The package's logger, writing to `log_path` and the console (the
    handlers of an earlier call are closed and replaced). With no path
    (a data-parallel rank other than 0) it writes no file, and to the
    console only warnings and errors."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if log_path else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    handlers = [logging.StreamHandler()]
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_path))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class MetricWriter:
    """Scalars to `<log_dir>/metrics.jsonl` (one JSON object a line: tag,
    value, step), and to TensorBoard where it is installed. With no
    log_dir (a data-parallel rank other than 0) it writes nothing."""

    def __init__(self, log_dir: str | None):
        self.logdir = log_dir
        self._jsonl = self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": step})
            + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
