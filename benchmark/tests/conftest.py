"""Shared pieces of the benchmark's CPU tests: the harness on the import
path, and a cell cut to a size a CPU test run holds (the same code path,
a 600-node graph, 6 epochs in chunks of 3, the rate lowered every 2)."""

import sys
from pathlib import Path

import pytest
import torch

# a few threads a test process: the suite runs several processes at once
torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def small_cell(name: str):
    from lib.spec import load_cell

    cell = load_cell(name)
    cell.config.update(num_nodes=600, avg_degree=4)
    cell.config["stage2"].update(num_epoch=6, scan_epochs=3, step_size=2)
    if cell.traffic["kind"] == "train_runs":
        cell.traffic.update(warmup_epochs=1, random_epochs=1,
                            embedding_samples=4096)
    else:
        cell.traffic.update(pool=4, warmup_requests=1)
    return cell


@pytest.fixture
def small():
    return small_cell
