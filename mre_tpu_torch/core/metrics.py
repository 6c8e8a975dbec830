"""Structured metric logging (copy of mre_tpu/core/metrics.py).

A JSONL metric writer (``metrics_<experiment_id>.jsonl`` in ``output_dir``)
with the JAX package's records and console line, and an optional wandb
passthrough when the library is importable and asked for.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from collections import deque
from typing import Mapping


class MetricLogger:
    def __init__(self, output_dir: str | None = None, experiment_id: str | None = None,
                 console: bool = True, use_wandb: bool = False, project: str = "mre_tpu"):
        self.experiment_id = experiment_id or uuid.uuid4().hex
        self.console = console
        self._fh = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, f"metrics_{self.experiment_id}.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=project, id=self.experiment_id, resume=True)
            except Exception:
                self._wandb = None

    def log(self, metrics: Mapping[str, float], step: int | None = None) -> None:
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = step
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.console:
            body = " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k not in ("time",))
            print(f"[metrics] {body}")
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def save_pickle(self, obj, filename: str) -> None:
        """Pickle ``obj`` beside the metrics file (module/utils.py:102-105)."""
        import pickle

        if self._fh:
            out_dir = os.path.dirname(self._fh.name)
            with open(os.path.join(out_dir, filename), "wb") as f:
                pickle.dump(obj, f)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


class RollingMean:
    """Rolling window mean (reference: main.py:114-118)."""

    def __init__(self, window: int):
        self._d = deque([], window)

    def add(self, value: float) -> None:
        self._d.append(float(value))

    @property
    def mean(self) -> float:
        return sum(self._d) / max(len(self._d), 1)

    def clear(self) -> None:
        self._d.clear()
