"""Training statistics: epoch averages, status lines, file-based plots.

The port's own copy of ``posediffusion_tpu.training.stats`` (that package's
``training/__init__`` imports JAX). It replaces the reference's
VizStats/Visdom stack (pose_diffusion/util/train_util.py:151-254): running
epoch averages per stat set, a ``sec/it`` clock, JSONL history next to the
checkpoints, and optional matplotlib dumps.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional


class StatsLogger:
    def __init__(self, log_vars: Iterable[str], jsonl_path: Optional[str] = None):
        self.log_vars = list(log_vars)
        self.jsonl_path = jsonl_path
        self.history: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        self._epoch_sums: Dict[str, Dict[str, float]] = {}
        self._epoch_counts: Dict[str, Dict[str, int]] = {}
        self._epoch = -1
        self._time_start = None

    @property
    def epoch(self) -> int:
        return self._epoch

    def new_epoch(self):
        self._flush_epoch()
        self._flushed = False
        self._epoch += 1
        self._epoch_sums = defaultdict(lambda: defaultdict(float))
        self._epoch_counts = defaultdict(lambda: defaultdict(int))
        self._time_start = time.time()
        self._its = defaultdict(int)

    def update(self, values: Dict[str, float], stat_set: str = "train"):
        self._its[stat_set] += 1
        elapsed = time.time() - self._time_start
        values = dict(values)
        values.setdefault("sec/it", elapsed / max(self._its[stat_set], 1))
        for k, v in values.items():
            if k not in self.log_vars:
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            self._epoch_sums[stat_set][k] += v
            self._epoch_counts[stat_set][k] += 1

    def epoch_average(self, k: str, stat_set: str = "train") -> Optional[float]:
        c = self._epoch_counts.get(stat_set, {}).get(k, 0)
        if not c:
            return None
        return self._epoch_sums[stat_set][k] / c

    def status_string(self, stat_set: str = "train", max_it: Optional[int] = None) -> str:
        parts = [f"[epoch {self._epoch} | {stat_set} | it {self._its.get(stat_set, 0)}"
                 + (f"/{max_it}]" if max_it else "]")]
        for k in self.log_vars:
            avg = self.epoch_average(k, stat_set)
            if avg is not None:
                parts.append(f"{k} {avg:.4f}")
        return " | ".join(parts)

    def flush(self):
        """Finalize the current epoch's averages into history/JSONL.  Call at
        the end of training; new_epoch() flushes the previous epoch
        automatically."""
        self._flush_epoch()

    def _flush_epoch(self):
        if self._epoch < 0 or getattr(self, "_flushed", False):
            return
        self._flushed = True
        record = {"epoch": self._epoch}
        for stat_set, sums in self._epoch_sums.items():
            for k in sums:
                avg = self.epoch_average(k, stat_set)
                self.history[stat_set][k].append(avg)
                record[f"{stat_set}/{k}"] = avg
        if self.jsonl_path:
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def plot(self, path: str):
        """Dump per-stat line plots (matplotlib, file only)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        stats = sorted({k for s in self.history.values() for k in s})
        if not stats:
            return
        ncol = 3
        nrow = (len(stats) + ncol - 1) // ncol
        fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False)
        for idx, stat in enumerate(stats):
            ax = axes[idx // ncol][idx % ncol]
            for stat_set, series in self.history.items():
                if stat in series:
                    ax.plot(series[stat], label=stat_set, linewidth=1)
            ax.set_ylabel(stat)
            ax.set_xlabel("epoch")
            ax.legend(fontsize=6)
            ax.grid(True, linewidth=0.3)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
