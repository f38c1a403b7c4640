"""Metric logging: CSV and, where installed, TensorBoard
(mask3d_tpu/train/logging_utils.py). `MetricLogger` keeps per-epoch means
of the per-step values itself and writes both sinks."""

from __future__ import annotations

import csv
import logging
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


# from mask3d_tpu/train/logging_utils.py:23 MetricLogger
class MetricLogger:
    """`write_files=False` (a rank other than 0 under data parallelism)
    aggregates the epoch means but never writes: no directory, CSV or
    TensorBoard file."""

    def __init__(self, directory: str, use_tensorboard: bool = True,
                 hyperparams: Optional[dict] = None,
                 write_files: bool = True):
        self.directory = directory
        self.write_files = write_files
        if write_files:
            os.makedirs(directory, exist_ok=True)
        self.csv_path = os.path.join(directory, "metrics.csv")
        self._csv_fields = ["epoch", "step"]
        self._csv_rows = []
        # The CSV is rewritten whole each epoch (its fields can grow), so a
        # resumed run seeds its history from the file it finds.
        if write_files and os.path.exists(self.csv_path):
            try:
                with open(self.csv_path, newline="") as f:
                    r = csv.DictReader(f)
                    for name in r.fieldnames or []:
                        if name not in self._csv_fields:
                            self._csv_fields.append(name)
                    self._csv_rows = [
                        {k: v for k, v in row.items() if v not in ("", None)}
                        for row in r
                    ]
            except (OSError, csv.Error, UnicodeDecodeError) as e:
                logger.warning(f"could not seed metrics.csv history: {e}")
        self._epoch_acc: Dict[str, list] = defaultdict(list)
        self._tb = None
        if use_tensorboard and write_files:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logger.warning(f"tensorboard unavailable, CSV only: {e}")
            else:
                self._tb = SummaryWriter(log_dir=directory)
                if hyperparams:
                    self._tb.add_text(
                        "hyperparams",
                        "\n".join(f"{k}: {v}" for k, v in hyperparams.items()),
                    )

    def log_step(self, metrics: Dict[str, float], step: int):
        """Accumulate for the epoch mean; also write per step to
        TensorBoard."""
        for k, v in metrics.items():
            v = float(v)
            self._epoch_acc[k].append(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{k}_step", v, step)

    def log_epoch(self, epoch: int, step: int,
                  extra: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
        """Flush the epoch means (and `extra`) as the epoch's CSV row; a
        row of the same epoch is replaced (a resumed run replays the
        epochs after its checkpoint)."""
        means = {
            k: float(np.mean(vs)) for k, vs in self._epoch_acc.items()
        }
        if extra:
            means.update({k: float(v) for k, v in extra.items()})
        self._epoch_acc.clear()
        row = {"epoch": epoch, "step": step, **means}
        for k in means:
            if k not in self._csv_fields:
                self._csv_fields.append(k)
        self._csv_rows = [
            r for r in self._csv_rows if int(r.get("epoch", -1)) != epoch
        ]
        self._csv_rows.append(row)
        if self.write_files:
            self._write_csv()
        if self._tb is not None:
            for k, v in means.items():
                self._tb.add_scalar(k, v, epoch)
            self._tb.flush()
        return means

    def _write_csv(self):
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields)
            w.writeheader()
            for row in sorted(self._csv_rows,
                              key=lambda r: int(r.get("epoch", -1))):
                w.writerow(row)

    def close(self):
        if self._tb is not None:
            self._tb.close()
