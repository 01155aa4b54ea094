"""Checkpoint / resume for stage-2 training, on ``torch.save``.

Port of ``bridged_gnn_tpu/train/checkpoint.py`` without orbax. A
checkpoint holds the full training state — model and optimizer state
dicts (the optimizer's holds the scheduled rate), the dropout generator's
state, the best-score dict and the epoch — so training resumes
deterministically, in either of the trainer's modes. Layout::

    <dir>/step_<n>.pt   (the newest ``keep`` are kept)
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch


class TrainCheckpointer:
    """Periodic checkpoints with resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name + ".pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write ``state`` (tensors, numbers, strings, lists and dicts of
        them) atomically, then drop all but the newest ``keep`` steps."""
        path = self._path(f"step_{step}")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for s in self.steps()[: -self.keep]:
            os.remove(self._path(f"step_{s}"))

    def steps(self) -> List[int]:
        return sorted(
            int(f[len("step_"):-len(".pt")])
            for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default: the newest); None when
        there is none. Tensors load on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(f"step_{step}")
        if not os.path.isfile(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)
