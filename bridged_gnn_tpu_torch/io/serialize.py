"""npz graph format: a flat dict of arrays ``x, edge_index, y,
train_mask, val_mask, test_mask, central_mask`` (port of
``bridged_gnn_tpu/io/serialize.py``: the same writer and reader, so each
package reads the other's files; checkpoints are not ported)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_graph_npz(path: str, data: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in data.items()})


def load_graph_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
