"""Inference/serving layer: full-graph KT-GNN node classification.

Port of ``bridged_gnn_tpu/serve.py::KTGNNPredictor``. The graph, its slot
layout and the model live on the device; every prediction is one forward
under ``torch.inference_mode()``. On the card each attention call is one
fused CUDA kernel launch per layout (``ops/fused_kernels.py``); the
serving layout is the single ``node_block=128`` padded layout (selective
kernel), or degree tiers (concatenated kernel per tier) when the graph's
skew calls for them.

``SimilarityScorer`` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import Graph, graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.train.stage2 import to_undirected_np
from bridged_gnn_tpu_torch.utils.platform import (
    check_matmul_precision,
    matmul_precision,
    resolve_device,
)


class KTGNNPredictor:
    """Serve class predictions over a bridged graph.

    ``state_dict``: weights to load into ``model`` (strict), or None to
    serve the model's current weights. ``adjacency_method``: ``"auto"``
    and ``"blocked"`` build the single layout unless the skew rule picks
    tiers; ``"tiered"`` forces tiers. ``matmul_precision``: JAX's
    precision name that every forward runs under (as the JAX serve CLI
    builds its predictor under ``jax.default_matmul_precision``); see
    ``utils/platform.matmul_precision``. A model built with
    ``msg_dtype="bfloat16"`` serves with bf16 messages as it is."""

    def __init__(self, model: torch.nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]],
                 data: Dict[str, np.ndarray],
                 to_undirected: bool = True,
                 adjacency_method: str = "auto",
                 device="cuda", matmul_precision: Optional[str] = None):
        check_matmul_precision(matmul_precision)
        self.matmul_precision = matmul_precision
        self.device = resolve_device(device)
        if to_undirected:
            data = to_undirected_np(data)
        self.graph = with_self_loops(graph_from_dict(data)).to(self.device)
        if adjacency_method == "auto":
            adjacency_method = "blocked"
        self.adj = adjacency_from_graph(
            self.graph, method=adjacency_method, node_block=128,
            device=self.device,
        )
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    def _forward(self, g: Graph) -> Dict[str, np.ndarray]:
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            lp_s, lp_t, lp_that = self.model(g, self.adj)
            n = g.num_nodes
            # one host transfer for all three heads
            both = torch.stack([lp_s[:n], lp_t[:n], lp_that[:n]]).cpu()
        lp = both.numpy()
        return dict(source=lp[0], target=lp[1], target_hat=lp[2])

    def predict(self) -> Dict[str, np.ndarray]:
        """Per-node log-probabilities from each head (real nodes only)."""
        return self._forward(self.graph)

    def _graph_with_features(self, x: Optional[np.ndarray],
                             nodes: Optional[np.ndarray] = None) -> Graph:
        """The serving graph with node features replaced (full [N, D]
        array) or partially updated (``nodes`` + matching rows)."""
        g = self.graph
        n, d = g.num_nodes, g.num_features
        x_new = g.x.clone()
        if nodes is None:
            x = np.asarray(x, dtype=np.float32)
            if x.shape != (n, d):
                raise ValueError(
                    f"features must be [{n}, {d}], got {list(x.shape)}")
            x_new[:n] = torch.from_numpy(x).to(self.device)
        else:
            nodes = np.asarray(nodes)
            if (nodes.ndim != 1
                    or not np.issubdtype(nodes.dtype, np.integer)):
                raise ValueError(
                    f"'nodes' must be a 1-D list of integer ids in "
                    f"[0, {n})")
            if (nodes < 0).any() or (nodes >= n).any():
                raise ValueError(f"'nodes' must be ids in [0, {n})")
            # an indexed assignment with a repeated id keeps an unspecified
            # one of its rows on CUDA
            if len(np.unique(nodes)) != len(nodes):
                raise ValueError("'nodes' must not repeat an id")
            rows = np.asarray(x, dtype=np.float32)
            if rows.shape != (len(nodes), d):
                raise ValueError(
                    f"rows must be [{len(nodes)}, {d}], got "
                    f"{list(rows.shape)}")
            x_new[torch.from_numpy(nodes.astype(np.int64)).to(
                self.device)] = torch.from_numpy(rows).to(self.device)
        return g.replace(x=x_new)

    def predict_live(self, x: Optional[np.ndarray] = None,
                     nodes: Optional[np.ndarray] = None,
                     ) -> Dict[str, np.ndarray]:
        """Run the model now on (optionally updated) features.

        ``x`` alone: full [N, D] feature replacement for this call.
        ``x`` + ``nodes``: partial row update of the stored features.
        Neither: re-run on the stored graph."""
        g = self.graph if x is None else self._graph_with_features(x, nodes)
        return self._forward(g)

    def update_features(self, x: np.ndarray,
                        nodes: Optional[np.ndarray] = None) -> None:
        """Persistently install new node features (full or partial); the
        next ``predict``/``predict_live`` sees them."""
        self.graph = self._graph_with_features(x, nodes)

    def predict_labels(self, head: str = "target_hat") -> np.ndarray:
        return self.predict()[head].argmax(1)

    def embeddings(self) -> np.ndarray:
        """Final-layer node embeddings (reference get_emb equivalent)."""
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            emb = self.model.embed(self.graph, self.adj)
            return emb[: self.graph.num_nodes].cpu().numpy()
