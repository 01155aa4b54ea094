"""Host time of a stage-2 run's slot layout, split by sub-step, with the
sender index built both ways in one process.

Builds the benchmark's ``ktgnn`` graph (``make_benchmark_graph(131072,
16, 256, 31, seed)``, undirected, self loops, on ``--device``), then
times ``adjacency_from_graph(g, "blocked", 128)`` as the trainer's
``stage2.layout`` range runs it, step by step:

* ``edges_to_host``: the graph's edge arrays copied back to the host;
* ``edges_to_card``: the adjacency's own edge tensors and in-degrees
  made and copied to the card;
* ``skew_rule``: ``ops/spmm.py::is_skewed``;
* ``slot_assignment``: ``ops/blocked_segment.py::_padded_layout_np``;
* ``sender_index``: the sender-keyed CSR, by numpy's stable argsort
  (``_sender_csr_numpy``, form ``numpy``) or by the native library's
  counting sort (``io/native.py::sender_csr``, form ``native``);
* ``derived``: the heavy rows of both indexes, each CSR entry's
  destination row and the sender bound;
* ``layout_to_card``: the layout's eight arrays copied to the card.

The card is synchronized at every step's end. Each form runs
``--repeats`` times, the two forms in turns, and also as a whole call of
``adjacency_from_graph`` (``whole_s``; the step sum leaves out only
Python's own work between them). Prints one JSON line per form with
each step's median seconds and every repeat's, and checks that both
forms give the same layout.

    python3 tools/torch_layout_split.py [--device cuda] [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bridged_gnn_tpu_torch.data.synthetic import (  # noqa: E402
    make_benchmark_graph,
)
from bridged_gnn_tpu_torch.graph import (  # noqa: E402
    graph_from_dict,
    to_undirected_np,
    with_self_loops,
)
from bridged_gnn_tpu_torch.io import native  # noqa: E402
from bridged_gnn_tpu_torch.ops import blocked_segment as bs  # noqa: E402
from bridged_gnn_tpu_torch.ops.spmm import (  # noqa: E402
    adjacency_from_graph,
    is_skewed,
)

NODE_BLOCK = 128
FORMS = dict(numpy=bs._sender_csr_numpy, native=native.sender_csr)


class _Steps:
    def __init__(self, device):
        self.device, self.times = device, {}
        self._t = self._now()

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def end(self, name):
        t = self._now()
        self.times[name] = t - self._t
        self._t = t


def split(g, sender_csr, device):
    """``adjacency_from_graph``'s blocked path, timed step by step."""
    steps = _Steps(device)
    s = g.senders.cpu().numpy()
    r = g.receivers.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    n_pad = g.num_nodes_padded
    steps.end("edges_to_host")
    for a in (s.astype(np.int32), r.astype(np.int32), em.astype(bool),
              np.bincount(r[em], minlength=n_pad).astype(np.float32)):
        torch.from_numpy(a).to(device)
    steps.end("edges_to_card")
    assert not is_skewed(r, em, n_pad, NODE_BLOCK)
    steps.end("skew_rule")
    slot_src, ranges, _, _, slot_edge, slot_row = bs._padded_layout_np(
        r.astype(np.int64), s.astype(np.int32), em, n_pad, NODE_BLOCK)
    steps.end("slot_assignment")
    src_ranges, src_slots = sender_csr(slot_src, n_pad)
    steps.end("sender_index")
    host = [slot_src, ranges, src_ranges, src_slots,
            bs.heavy_rows_np(ranges), bs.heavy_rows_np(src_ranges),
            slot_edge, slot_row[src_slots]]
    int(slot_src.max())                 # the sender bound
    steps.end("derived")
    for a in host:
        torch.from_numpy(a).to(device)
    steps.end("layout_to_card")
    return steps.times


def whole(g, sender_csr, device):
    saved = bs._sender_csr_np
    bs._sender_csr_np = sender_csr
    try:
        t = _Steps(device)
        adj = adjacency_from_graph(g, "blocked", NODE_BLOCK, device)
        t.end("whole_s")
    finally:
        bs._sender_csr_np = saved
    return t.times["whole_s"], adj.fast_fn.lay_dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    device = torch.device(args.device)
    t = time.perf_counter()
    data = to_undirected_np(
        make_benchmark_graph(131072, 16, 256, 31, args.seed))
    g = with_self_loops(graph_from_dict(data)).to(device)
    build_s = time.perf_counter() - t
    native.load()                       # built before any timing
    runs = {form: [] for form in FORMS}
    layouts = {}
    for _ in range(args.repeats):
        for form, fn in FORMS.items():
            times = split(g, fn, device)
            times["whole_s"], layouts[form] = whole(g, fn, device)
            runs[form].append(times)
    same = all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(layouts["numpy"], layouts["native"]))
    for form, rows in runs.items():
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        print(json.dumps(dict(
            form=form, device=str(device), graph_build_s=build_s,
            real_slots=int(layouts[form].src_slots.shape[0]),
            same_layout=same, median_s=med,
            runs=[{k: round(v, 5) for k, v in r.items()} for r in rows])),
            flush=True)


if __name__ == "__main__":
    main()
