"""Inference/serving layer: full-graph node classification with any
stage-2 model.

Port of ``bridged_gnn_tpu/serve.py::KTGNNPredictor``. The graph, its
adjacency and the model live on the device; every prediction is one
forward under ``torch.inference_mode()``. On the card each KT-GNN
attention call is one fused CUDA kernel launch per layout
(``ops/fused_kernels.py``): the single ``node_block=128`` padded layout
(selective kernel), or degree tiers (concatenated kernel per tier) when
the graph's skew calls for them; a zoo model's SpMMs run the padded SpMM
kernel on its ``node_block=256`` layout. ``"auto"`` resolves by
``ops/spmm.py::resolve_adjacency_method``; on a dense or gather
adjacency the attention and the SpMMs are plain PyTorch.

``SimilarityScorer`` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import Graph, graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN, KTGNNNoDTC
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.train.stage2 import to_undirected_np
from bridged_gnn_tpu_torch.utils.platform import (
    check_matmul_precision,
    matmul_precision,
    resolve_device,
)


class KTGNNPredictor:
    """Serve class predictions over a bridged graph.

    ``model``: KT-GNN, whose three heads the predictions hold, or any
    single-output stage-2 model (``KTGNNNoDTC``, the zoo), whose
    log-probabilities stand for all three heads (JAX ``serve.py:73-79``).
    The graph gets self loops for every model, as the JAX predictor adds
    them (``serve.py:43``), also for the zoo models that trained without
    them (GraphSAGE, GIN, MLP, DeeperGCN, ConvNet).
    ``state_dict``: weights to load into ``model`` (strict), or None to
    serve the model's current weights. ``adjacency_method``: ``"auto"``
    resolves by the padded node count, as the trainer does;
    ``"blocked"`` builds the single layout unless the skew rule picks
    tiers; ``"tiered"``, ``"dense"`` and ``"gather"`` force theirs.
    ``matmul_precision``: JAX's
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
        self.adj = adjacency_from_graph(
            self.graph, method=adjacency_method,
            node_block=128 if isinstance(model, (KTGNN, KTGNNNoDTC)) else 256,
            device=self.device,
        )
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    def _forward(self, g: Graph) -> Dict[str, np.ndarray]:
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            outs = self.model(g, self.adj)
            lp_s, lp_t, lp_that = (outs[:3] if isinstance(outs, tuple)
                                   else (outs,) * 3)
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
        """Final-layer node embeddings (reference get_emb equivalent); a
        KT-GNN model's alone."""
        if not hasattr(self.model, "embed"):
            raise ValueError(
                f"{type(self.model).__name__} has no node embeddings; "
                "embeddings() serves KT-GNN")
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            emb = self.model.embed(self.graph, self.adj)
            return emb[: self.graph.num_nodes].cpu().numpy()
