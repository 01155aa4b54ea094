"""The port's own profiler ranges, as its ``utils/profiling.py`` keeps
them while a profiler runs: here, in a traced run, the traced training
run's or the traced requests'. Read from the module already loaded
(``sys.modules``), never imported: a run that never loaded the port, or
a port that keeps no log, gives nothing.

Each range has a ``name``, ``start_ns`` and ``end_ns`` on the host
clock, the log index of its ``parent`` and of its ``root`` (one training
run, ``stage2.train``; one request, ``serve.predict``), and ``counts``.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from lib.stats import percentile

MODULE = "bridged_gnn_tpu_torch.utils.profiling"


def log() -> list:
    recorded = getattr(sys.modules.get(MODULE), "recorded", None)
    return list(recorded()) if recorded is not None else []


def roots(root: str) -> List[list]:
    """The ranges of each root range named ``root``, the root's own
    included, one list a root in the order the roots opened."""
    spans = log()
    out: Dict[int, list] = {}
    for s in spans:
        if spans[s.root].name == root:
            out.setdefault(s.root, []).append(s)
    return list(out.values())


def seconds(group: list, *names: str) -> float:
    return sum(s.end_ns - s.start_ns for s in group if s.name in names) * 1e-9


def per_root(root: str, *names: str) -> Optional[List[float]]:
    """Each ``root`` range's summed seconds in its ranges named ``names``;
    None when no such root holds one."""
    groups = roots(root)
    if not any(s.name in names for g in groups for s in g):
        return None
    return [seconds(g, *names) for g in groups]


def mean_per_root(root: str, *names: str) -> Optional[float]:
    v = per_root(root, *names)
    return None if v is None else sum(v) / len(v)


def median_per_root(root: str, *names: str) -> Optional[float]:
    v = per_root(root, *names)
    return None if v is None else percentile(v, 50)
