"""Episode metric logging: CSV stream + optional TensorBoard scalars.

Counterpart of `plasticinelab_tpu/algorithms/logger.py` (plain Python, the
same output); behavioral reference plb/algorithms/logger.py. A `train` CSV
with columns step, reward, loss, sdf, density, contact, total_iou,
last_iou: one line per episode, the loss components summed over the
episode; the same scalars under `log/*` in TensorBoard where a writer
imports (`torch.utils.tensorboard` or `tensorboardX`; none is needed); a
per-episode fps print.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import Optional


CSV_COLUMNS = ("step", "reward", "loss", "sdf", "density", "contact",
               "total_iou", "last_iou")

# env-info key -> CSV column for the summed loss components
_SUMMED = (("loss", "loss"), ("sdf_loss", "sdf"), ("density_loss", "density"),
           ("contact_loss", "contact"), ("incremental_iou", "total_iou"))


@dataclass(frozen=True)
class EpisodeStats:
    """Accumulated metrics of one running episode."""

    reward: float = 0.0
    loss: float = 0.0
    sdf: float = 0.0
    density: float = 0.0
    contact: float = 0.0
    total_iou: float = 0.0
    last_iou: float = 0.0

    def accumulate(self, reward: float, info: dict) -> "EpisodeStats":
        updates = {"reward": self.reward + reward,
                   "last_iou": info["incremental_iou"]}
        for src, dst in _SUMMED:
            updates[dst] = getattr(self, dst) + info[src]
        return replace(self, **updates)

    def row(self, step: int) -> dict:
        return {"step": step, **{c: getattr(self, c) for c in CSV_COLUMNS
                                 if c != "step"}}


class _CsvSink:
    def __init__(self, path: str):
        self.path = path
        with open(path, "w") as f:
            f.write(",".join(CSV_COLUMNS) + "\n")

    def __call__(self, row: dict):
        with open(self.path, "a") as f:
            f.write(",".join(str(row[c]) for c in CSV_COLUMNS) + "\n")


class _TensorboardSink:
    def __init__(self, log_dir: str):
        if not log_dir.endswith("log"):
            log_dir = os.path.join(log_dir, "log")
        self._writer = None
        for modname in ("torch.utils.tensorboard", "tensorboardX"):
            try:
                import importlib

                mod = importlib.import_module(modname)
                self._writer = mod.SummaryWriter(log_dir=log_dir)
                break
            except Exception:
                continue

    def __call__(self, row: dict):
        if self._writer is None:
            return
        for col, val in row.items():
            if col != "step":
                self._writer.add_scalar(f"log/{col}", val, row["step"])


class Logger:
    """Same call surface the solvers/RL loops expect: reset() at episode
    start, step(...) per env step; episode totals flush on done."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.sinks = [_CsvSink(os.path.join(path, "train")),
                      _TensorboardSink(path)]
        self.steps = 0
        self.episode = 0
        self._stats: Optional[EpisodeStats] = None
        self._t0: Optional[float] = None

    def reset(self):
        self.episode += 1
        self._stats = EpisodeStats()

    def step(self, state, action, reward, next_state, done, info):
        assert self._stats is not None, "please reset logger."
        if self._t0 is None:
            self._t0 = time.time()
        self.steps += 1
        self._stats = self._stats.accumulate(float(reward), info)
        if done:
            self._flush()

    def _flush(self):
        fps = self.steps / max(time.time() - self._t0, 1e-9)
        print(
            f"STEP: {self.steps}, reward {self._stats.reward} "
            f"last_iou {self._stats.last_iou}   fps: {fps}"
        )
        row = self._stats.row(self.steps)
        for sink in self.sinks:
            sink(row)
        self._stats = None
