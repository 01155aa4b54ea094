"""Inference/serving layer: full-graph node classification with any
stage-2 model, and top-k similar-source queries with a stage-1 model.

Port of ``bridged_gnn_tpu/serve.py``. ``KTGNNPredictor``: the graph, its
adjacency and the model live on the device; every prediction is one
forward under ``torch.inference_mode()``. On the card each KT-GNN
attention call is one fused CUDA kernel launch per layout
(``ops/fused_kernels.py``): the single ``node_block=128`` padded layout
(selective kernel), or degree tiers (concatenated kernel per tier) when
the graph's skew calls for them; a zoo model's SpMMs run the padded SpMM
kernel on its ``node_block=256`` layout. ``"auto"`` resolves by
``ops/spmm.py::resolve_adjacency_method``; on a dense or gather
adjacency the attention and the SpMMs are plain PyTorch. The heads come
back into resident host buffers of the predictor's ``HostPool``
(page-locked on the card), each lent with its answer until the caller
drops it.

``SimilarityScorer``: the online counterpart of the bridge build. The
source corpus is encoded once and its columns projected through the
similarity head; each query batch is encoded through the target
autoencoder (a ``gnn`` backbone's SAGE aggregations run the padded SpMM
kernel) and scored against every source column blockwise, with the
bridge's top-k (``ops/sddmm.py``: ``lax.top_k``'s tie order).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import (
    Graph,
    build_graph,
    graph_from_dict,
    slot_node_block,
    to_undirected_np,
    with_self_loops,
)
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN, KTGNNNoDTC
from bridged_gnn_tpu_torch.ops.sddmm import (
    blockwise_pair_scores_topk,
    cosine_score_block,
    pair_mlp_score_block,
)
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.utils.profiling import annotate
from bridged_gnn_tpu_torch.utils.platform import (
    check_matmul_precision,
    matmul_precision,
    resolve_device,
)

# host buffers a predictor keeps for the heads, per shape and dtype
POOL_BUFFERS = 8


class _Lease:
    """One answer's hold on a pooled host buffer. The answer's arrays are
    numpy views whose ``base`` chain ends here, so the lease lives exactly
    as long as the last of them."""

    __slots__ = ("__array_interface__", "buffer", "__weakref__")

    def __init__(self, buffer: torch.Tensor):
        self.buffer = buffer
        self.__array_interface__ = buffer.numpy().__array_interface__


class HostPool:
    """Resident host buffers that the heads are copied into, at most
    :data:`POOL_BUFFERS` for each shape and dtype, page-locked when the
    heads are on a card (``pin_memory``) and plain arrays otherwise.

    A buffer is lent with the answer made of it and comes back only when
    the caller has dropped every array of that answer, so a later request
    never writes over an answer still held. With every buffer of a shape
    lent, :meth:`take` gives None and the caller copies to a fresh array.
    """

    def __init__(self):
        self._lock = threading.Lock()   # a lease may end on any thread
        self._free: Dict[tuple, list] = {}
        self._made: Dict[tuple, int] = {}

    def take(self, shape, dtype: torch.dtype, pin: bool
             ) -> Optional[Tuple[torch.Tensor, np.ndarray]]:
        """A free buffer of ``shape`` and ``dtype`` (made when fewer than
        :data:`POOL_BUFFERS` are) and the numpy array lent over it; None
        when every one is lent."""
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if free:
                buffer = free.pop()
            elif self._made.get(key, 0) < POOL_BUFFERS:
                self._made[key] = self._made.get(key, 0) + 1
                buffer = None
            else:
                return None
        if buffer is None:
            buffer = torch.empty(shape, dtype=dtype, pin_memory=pin)
        lease = _Lease(buffer)
        weakref.finalize(lease, self._give_back, key, buffer)
        return buffer, np.asarray(lease)

    def _give_back(self, key: tuple, buffer: torch.Tensor) -> None:
        with self._lock:
            self._free[key].append(buffer)

    def counts(self) -> Dict[tuple, Tuple[int, int]]:
        """Per ``(shape, dtype)``: the buffers made and those free now."""
        with self._lock:
            return {k: (n, len(self._free[k])) for k, n in self._made.items()}


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
            node_block=slot_node_block(
                isinstance(model, (KTGNN, KTGNNNoDTC))),
            device=self.device,
        )
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.host_pool = HostPool()

    def _forward(self, g: Graph) -> Dict[str, np.ndarray]:
        """The heads' log-probabilities over ``g``: the forward and the
        heads' stack launched, and a host buffer for them taken from
        :attr:`host_pool` while the card works (range ``serve.forward``);
        the host waiting for the card (``serve.wait``); one copy of all
        three heads into the buffer (``serve.copy``, with its ``bytes`` and
        ``pooled``: 1 when the buffer came from the pool).

        The answer's three arrays are views of that buffer and are the
        caller's: no later request writes into it while any of them is
        held, and it goes back to the pool once all are dropped. The pool
        keeps at most :data:`POOL_BUFFERS` buffers per heads' shape and
        dtype (page-locked on a card); with every one held, the heads go
        to a fresh pageable array instead, alike but slower to fill."""
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            with annotate("serve.forward"):
                outs = self.model(g, self.adj)
                lp_s, lp_t, lp_that = (outs[:3] if isinstance(outs, tuple)
                                       else (outs,) * 3)
                n = g.num_nodes
                both = torch.stack([lp_s[:n], lp_t[:n], lp_that[:n]])
                lent = self.host_pool.take(both.shape, both.dtype,
                                           both.is_cuda)
                host, lp = lent or (torch.empty(both.shape, dtype=both.dtype),
                                    None)
            with annotate("serve.wait"):
                # the copy then starts with nothing else in flight
                if both.is_cuda:
                    torch.cuda.current_stream(both.device).synchronize()
            with annotate("serve.copy", bytes=host.numel() * host.element_size(),
                          pooled=int(lent is not None)):
                host.copy_(both)
        if lp is None:
            lp = host.numpy()
        return dict(source=lp[0], target=lp[1], target_hat=lp[2])

    def predict(self) -> Dict[str, np.ndarray]:
        """Per-node log-probabilities from each head (real nodes only);
        under ``torch.profiler`` one range, ``serve.predict``. The arrays
        are the caller's until dropped (see :meth:`_forward`: their host
        memory is then recycled, at most :data:`POOL_BUFFERS` buffers a
        shape)."""
        with annotate("serve.predict"):
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
        Neither: re-run on the stored graph.

        Under ``torch.profiler`` the call is one range, ``serve.predict``,
        holding the feature update (``serve.update``) and
        :meth:`_forward`'s. The answer's arrays are the caller's until
        dropped, then their pooled host memory is recycled (at most
        :data:`POOL_BUFFERS` buffers a shape; see :meth:`_forward`)."""
        with annotate("serve.predict"):
            g = self.graph
            if x is not None:
                with annotate("serve.update"):
                    g = self._graph_with_features(x, nodes)
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


class SimilarityScorer:
    """Online cross-domain similarity over a fixed source corpus (JAX
    ``serve.py:174-361``).

    ``model``: a stage-1 ``AdversarialLearnerV2``; ``state_dict``: weights
    to load into it (strict), or None for its own. ``g_src``: the source
    corpus graph; ``adj_src``: its adjacency, built when None and the
    backbone is ``gnn``. The corpus is encoded once, in eval mode, and its
    columns projected: the mlp head's source factor
    (``bridge/build.py::decompose_pair_mlp_head``), or the cosine head's
    lin_self and biasatt residual (``_embed_cosine_side``).
    ``approx_recall``: as the bridge's, exact off the TPU."""

    def __init__(self, model: torch.nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]],
                 g_src: Graph, adj_src=None, sim_mode: str = "mlp",
                 row_block: int = 256,
                 approx_recall: Optional[float] = None, device="cuda"):
        from bridged_gnn_tpu_torch.bridge.build import (
            _embed_cosine_side,
            decompose_pair_mlp_head,
        )
        from bridged_gnn_tpu_torch.ops.sddmm import _check_recall

        _check_recall(approx_recall)
        self.device = resolve_device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.sim_mode = sim_mode
        self.row_block = row_block
        self.approx_recall = approx_recall
        self.gnn = model.source_learner.backbone == "gnn"
        self.dim_in_tar = \
            model.target_learner.equavilent_trans_layer_0.weight.shape[1]
        g_src = g_src.to(self.device)
        if adj_src is None and self.gnn:
            adj_src = adjacency_from_graph(g_src, "auto",
                                           device=self.device)
        self.num_src = g_src.num_nodes
        with torch.no_grad():
            z_src = model.source_learner.encode(
                g_src.x, adj_src, g_src.node_mask)[: self.num_src].float()
            if sim_mode == "mlp":
                head = decompose_pair_mlp_head(model)

                def t(a):
                    return torch.from_numpy(
                        np.ascontiguousarray(a)).to(self.device)

                self._w_tar = t(head["w_tar"])
                self._cols = z_src @ t(head["w_src"])
                self._head = (t(head["bias"]), t(head["w2"]), head["b2"])
            elif sim_mode == "cosine":
                self._project = lambda z: _embed_cosine_side(model, z)
                self._cols = self._project(z_src)
            else:
                raise ValueError(sim_mode)

    def _score_fn(self, z_rows: torch.Tensor):
        """The score closure of encoded query rows: each side's head
        projection, then the head's pair score against every column."""
        if self.sim_mode == "mlp":
            return pair_mlp_score_block(z_rows @ self._w_tar, self._cols,
                                        *self._head)
        return cosine_score_block(self._project(z_rows), self._cols)

    def _encode_queries(self, x: np.ndarray, n: int,
                        adj=None) -> torch.Tensor:
        """Eval-mode target embeddings of the rows ``x``, the first ``n``
        real (the statistics' mask), as isolated nodes (a self-loop
        graph, so a SAGE mean sees the node alone) unless ``adj``, the
        queries' own adjacency, is given."""
        loops = np.arange(x.shape[0], dtype=np.int64)
        g = build_graph(x, np.stack([loops, loops])).to(self.device)
        if adj is None and self.gnn:
            adj = adjacency_from_graph(g, "auto", device=self.device)
        mask = torch.arange(g.num_nodes_padded, device=self.device) < n
        return self.model.target_learner.encode(g.x, adj, mask)[0]

    def topk_sources(self, x_tar: np.ndarray, k: int, adj_tar=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The ``k`` most similar source nodes of every query row: values
        [n, k] descending (equal values by ascending column, as
        ``lax.top_k``) and their source ids [n, k].

        Without ``adj_tar`` the rows are padded to a multiple of 8 and
        encoded as isolated nodes, the padding left out of the batch
        statistics' mask; row blocks are JAX's (``serve.py:303-308``: as
        few blocks of ``row_block`` as the padded rows need, each a
        multiple of 8). ``adj_tar``: the queries' adjacency over their
        own padded graph, for queries that form one."""
        x_tar = np.asarray(x_tar, dtype=np.float32)
        n = x_tar.shape[0]
        with torch.no_grad():
            if adj_tar is not None:
                z = self._encode_queries(x_tar, n, adj_tar)
                rows, row_block = n, self.row_block
            else:
                rows = max(8, _round8(n))
                x_pad = np.zeros((rows, x_tar.shape[1]), np.float32)
                x_pad[:n] = x_tar
                z = self._encode_queries(x_pad, n)
                n_blocks = -(-rows // min(self.row_block, rows))
                row_block = _round8(-(-rows // n_blocks))
            vals, idxs = blockwise_pair_scores_topk(
                self._score_fn(z[:rows].float()), rows, self.num_src, k,
                row_block=row_block, approx_recall=self.approx_recall,
                device=self.device)
            return vals[:n].cpu().numpy(), idxs[:n].cpu().numpy()


def _round8(n: int) -> int:
    return -(-n // 8) * 8
