"""Epoch timing (the port's counterpart of ``utils/profiling.StepTimer``).

Card work runs asynchronously, so the timer synchronizes the device
before it reads the clock at both ends of a step: a step's time is the
host clock around work that has finished on the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class EpochTimer:
    """Wall-clock step times on ``device`` and their summary; the first
    ``warmup`` steps are left out of the steady-state statistics."""

    def __init__(self, device: torch.device, num_edges: int = 0,
                 warmup: int = 2):
        self.device = torch.device(device)
        self.num_edges = num_edges
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    @property
    def steady(self) -> np.ndarray:
        return np.asarray(self.times[self.warmup:] or self.times)

    def summary(self) -> Dict[str, float]:
        s = self.steady
        mean = float(s.mean()) if len(s) else float("nan")
        out = dict(
            mean_s=mean,
            p50_s=float(np.percentile(s, 50)) if len(s) else float("nan"),
            p95_s=float(np.percentile(s, 95)) if len(s) else float("nan"),
            steps=len(self.times),
        )
        if self.num_edges and mean > 0:
            out["edges_per_sec"] = self.num_edges / mean
        return out
