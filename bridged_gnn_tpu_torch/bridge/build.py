"""Bridged-graph construction: top-k edge proposal → validity filters →
merge (port of ``bridged_gnn_tpu/bridge/build.py``; reference
main_bridged_graph.py:33-321).

  * Both domains are encoded once, in eval mode, on the model's device
    (the reference re-encodes them for every batch); the all-pairs
    scoring and row top-k is ``ops/sddmm.py``: for the cosine head one
    matmul of the folded embeddings per row block, for the mlp head the
    eval-mode head decomposed into per-side projections.
  * The four validity filters run on the host in numpy, over the
    proposals in row-major (target, k) order, as in the JAX package.
  * Merge and reorder are ``graph.py``'s index transforms.

Quirks kept from the reference: ``epsilon`` is accepted and unused;
cross edges run source → target; within-domain proposals keep
self-pairs. ``reference_compat=True`` replays the reference's
misaligned filter-1 quantile cut (proposals sorted into PyG coalesce
order before the filters, the similarities left in row-major order),
for cross and within edges alike.

``mesh``: a process group (``parallel/mesh.py::make_group``, the port's
``make_mesh``) whose ranks all call :func:`gen_bridged_graph` with the
same model and graphs. The cross and both within top-ks then split their
columns over the ranks (``parallel/topk.py::sharded_pair_topk``; JAX
``bridge/build.py:313-351, 475-522``); the embeddings and classifier
probabilities are rank 0's on every rank, and the host filters and the
merge run alike on every rank, so each returns the same graph.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.graph import (
    Graph,
    coalesce_np,
    merge_graphs_np,
    reorder_np,
)
from bridged_gnn_tpu_torch.nn.common import MaskedBatchNorm
from bridged_gnn_tpu_torch.ops.sddmm import (
    blockwise_pair_scores_topk,
    blockwise_rerank_topk,
    cosine_score_block,
    mlp_score_candidates,
    pair_mlp_score_block,
)

Tensor = torch.Tensor


def _np(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def _timed(timings: Optional[dict], name: str, device):
    """Add the block's seconds on the host clock to ``timings[name]``,
    the device synchronized at both ends; nothing when ``timings`` is
    None."""
    if timings is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _bn_affine(bn: MaskedBatchNorm) -> Tuple[np.ndarray, np.ndarray]:
    """An eval-mode batch norm as (scale, shift) per channel, in numpy
    float32 as the JAX package computes it."""
    s = _np(bn.weight) / np.sqrt(_np(bn.running_var) + np.float32(bn.eps))
    return s, _np(bn.bias) - _np(bn.running_mean) * s


def decompose_pair_mlp_head(model) -> Dict[str, np.ndarray]:
    """The eval-mode ``mlp`` head (BN0(2H) → Linear1(2H, 128) → BN2(128) →
    ReLU → Linear4(128, 1) → sigmoid over ``concat(z_src[i], z_tar[j])``)
    split into per-side projections: both batch norms are affine in eval
    mode, so the pre-ReLU activation is ``A(z_src) + B(z_tar) + bias``."""
    sim = model.source_learner.sim_net
    s0, t0 = _bn_affine(sim.lin_self_0)
    w1 = _np(sim.lin_self_1.weight).T                 # [2H, 128]
    b1 = _np(sim.lin_self_1.bias)
    h = w1.shape[0] // 2
    s2, t2 = _bn_affine(sim.lin_self_2)
    w2 = _np(sim.lin_self_4.weight)[0]                # [128]
    b2 = float(_np(sim.lin_self_4.bias)[0])
    w_src = (s0[:h, None] * w1[:h]) * s2[None, :]     # [H, 128]
    w_tar = (s0[h:, None] * w1[h:]) * s2[None, :]
    bias = (t0[:h] @ w1[:h] + t0[h:] @ w1[h:] + b1) * s2 + t2
    return dict(w_src=w_src, w_tar=w_tar, bias=bias, w2=w2, b2=b2)


def _embed_cosine_side(model, z: Tensor) -> Tensor:
    """The cosine head's lin_self and biasatt residual in eval mode."""
    sim = model.source_learner.sim_net
    dev = z.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    s0, t0 = _bn_affine(sim.lin_self_0)
    s2, t2 = _bn_affine(sim.lin_self_2)
    with torch.no_grad():
        h = (z * t(s0) + t(t0)) @ sim.lin_self_1.weight.t()
        zz = torch.tanh(h * t(s2) + t(t2)) @ sim.lin_self_4.weight.t()
        return sim.biasatt(zz)


def _rank0(group, *tensors: Tensor) -> Tuple[Tensor, ...]:
    """``tensors`` as rank 0 of ``group`` holds them, on every rank (the
    ranks' own copies may part in their last bits)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        out.append(t)
    return tuple(out)


def _topk_grid(model, z_rows: Tensor, z_cols: Tensor, k: int,
               sim_mode: str, row_block: int, approx_recall=None,
               rerank_candidates=None, mesh=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise top-k of the pair-similarity matrix of target-side rows
    ``z_rows`` [R, H] against source-side columns ``z_cols`` [C, H]:
    (values [R, k], columns [R, k]) on the host.

    ``rerank_candidates`` (mlp mode): screen the columns with the bf16
    cosine of the raw stage-1 embeddings, as the JAX package does (so the
    candidate sets are its), then score the exact head at the top
    ``rerank_candidates`` columns of each row. ``mesh``: a process group
    whose ranks split the columns (:func:`~bridged_gnn_tpu_torch.parallel.
    topk.sharded_pair_topk`)."""
    n_rows, n_cols = z_rows.shape[0], z_cols.shape[0]
    dev = z_rows.device
    with torch.no_grad():
        if mesh is not None:
            from bridged_gnn_tpu_torch.parallel.topk import (
                sharded_pair_topk,
            )
        if sim_mode == "mlp":
            d = decompose_pair_mlp_head(model)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            a_rows = z_rows @ t(d["w_tar"])
            b_cols = z_cols @ t(d["w_src"])
            head = (a_rows, b_cols, t(d["bias"]), t(d["w2"]), d["b2"])
            if mesh is not None:
                vals, idxs = sharded_pair_topk(
                    mesh, a_rows, b_cols, n_rows, n_cols, k, mode="mlp",
                    mlp_bias1=head[2], mlp_w2=head[3], mlp_b2=head[4],
                    row_block=row_block, approx_recall=approx_recall,
                    rerank_candidates=rerank_candidates, z_rows=z_rows,
                    z_cols=z_cols)
            elif rerank_candidates is not None:
                proxy = cosine_score_block(z_rows.bfloat16(),
                                           z_cols.bfloat16())
                vals, idxs = blockwise_rerank_topk(
                    proxy, mlp_score_candidates(*head), n_rows, n_cols, k,
                    candidates=int(rerank_candidates), row_block=row_block,
                    approx_recall=approx_recall, device=dev)
            else:
                vals, idxs = blockwise_pair_scores_topk(
                    pair_mlp_score_block(*head), n_rows, n_cols, k,
                    row_block=row_block, approx_recall=approx_recall,
                    device=dev)
        elif sim_mode == "cosine" and mesh is not None:
            vals, idxs = sharded_pair_topk(
                mesh, _embed_cosine_side(model, z_rows),
                _embed_cosine_side(model, z_cols), n_rows, n_cols, k,
                mode="cosine", row_block=row_block,
                approx_recall=approx_recall)
        elif sim_mode == "cosine":
            fn = cosine_score_block(_embed_cosine_side(model, z_rows),
                                    _embed_cosine_side(model, z_cols))
            vals, idxs = blockwise_pair_scores_topk(
                fn, n_rows, n_cols, k, row_block=row_block,
                approx_recall=approx_recall, device=dev)
        else:
            raise ValueError(sim_mode)
    return _np(vals), _np(idxs)


def _encode(model, g_src: Graph, adj_src, g_tar: Graph, adj_tar
            ) -> Tuple[Tensor, Tensor]:
    model.eval()
    with torch.no_grad():
        z_src, z_tar = model.encode_domains(
            g_src.x, adj_src, g_tar.x, adj_tar, g_src.node_mask,
            g_tar.node_mask)
    return z_src[: g_src.num_nodes].float(), z_tar[: g_tar.num_nodes].float()


def _encode_within(model, g: Graph, adj, domain: str) -> Tensor:
    model.eval()
    with torch.no_grad():
        if domain == "source":
            z = model.source_learner.encode(g.x, adj, g.node_mask)
        else:
            z = model.target_learner.encode(g.x, adj, g.node_mask)[0]
    return z[: g.num_nodes].float()


def labeled_homophily(y_from, y_to, edge_index) -> float:
    labeled = (y_from[edge_index[0]] != -1) & (y_to[edge_index[1]] != -1)
    return float(
        ((y_from[edge_index[0]] == y_to[edge_index[1]]) & labeled).sum()
        / max(labeled.sum(), 1)
    )


def propose_cross_edges(
    model, g_src: Graph, adj_src, g_tar: Graph, adj_tar, k: int,
    row_block: int = 512, sim_mode: str = "mlp",
    epsilon: float = 0.5,  # accepted and unused, as the reference's (:33)
    approx_recall=None, rerank_candidates=None, timings=None, mesh=None,
):
    """Top-k source neighbours of every target node (reference
    ``add_topk_sim_cross_domain_edges``, main_bridged_graph.py:33-75).
    Returns (flat edge_index [2, N_tar·k] in row-major (tar, k) order,
    aligned with ``sims.reshape(-1)``; sims [N_tar, k]; the classifier's
    probabilities on source and target; the labeled proposals'
    homophily). ``timings`` and ``mesh``: see :func:`gen_bridged_graph`."""
    dev = g_src.x.device
    with _timed(timings, "encode", dev):
        z_src, z_tar = _encode(model, g_src, adj_src, g_tar, adj_tar)
        with torch.no_grad():   # eval mode, as _encode left the model
            p_src, p_tar = (
                torch.exp(model.source_learner.sim_net.classify(z))
                for z in (z_src, z_tar))
        if mesh is not None:
            z_src, z_tar, p_src, p_tar = _rank0(mesh, z_src, z_tar, p_src,
                                                p_tar)
    with _timed(timings, "cross_topk", dev):
        vals, idxs = _topk_grid(model, z_tar, z_src, k, sim_mode,
                                row_block, approx_recall, rerank_candidates,
                                mesh)
    n_tar = g_tar.num_nodes
    edge_index = np.stack([idxs.reshape(-1),
                           np.repeat(np.arange(n_tar), k)]).astype(np.int64)
    y_src = _np(g_src.y)[: g_src.num_nodes]
    y_tar = _np(g_tar.y)[:n_tar]
    homo = labeled_homophily(y_src, y_tar, edge_index)
    return edge_index, vals, _np(p_src), _np(p_tar), homo


def propose_within_edges(
    model, g: Graph, adj, domain: str, k: int, row_block: int = 512,
    sim_mode: str = "mlp", approx_recall=None, rerank_candidates=None,
    mesh=None,
):
    """Top-k within-domain neighbours of every node, self-pairs kept as
    the reference keeps them (main_bridged_graph.py:97). Returns the flat
    sim-aligned edges and the sim grid. ``mesh``: see
    :func:`gen_bridged_graph`."""
    z = _encode_within(model, g, adj, domain)
    if mesh is not None:
        (z,) = _rank0(mesh, z)
    vals, idxs = _topk_grid(model, z, z, k, sim_mode, row_block,
                            approx_recall, rerank_candidates, mesh)
    edge_index = np.stack([idxs.reshape(-1),
                           np.repeat(np.arange(g.num_nodes), k)]
                          ).astype(np.int64)
    return edge_index, vals


def _pyg_coalesce_order(edge_index: np.ndarray) -> np.ndarray:
    """Edges sorted by (src, dst): the order PyG's ``coalesce`` leaves
    top-k proposals in (they hold no duplicates)."""
    order = np.lexsort((edge_index[1], edge_index[0]))
    return edge_index[:, order]


def check_cross_validity(
    edge_index: np.ndarray, e_sim: np.ndarray, y_src: np.ndarray,
    y_tar: np.ndarray, x_src: np.ndarray, x_tar: np.ndarray,
    train_mask_tar: np.ndarray, probs_clf_src: np.ndarray,
    probs_clf_tar: np.ndarray, thres_conf_quantile: float = 0.1,
    thres_feat_sim: float = 0.0, verbose: bool = False,
) -> np.ndarray:
    """The four cross-domain filters in the reference's order
    (main_bridged_graph.py:225-264), on sim-aligned flat edges."""
    y_src, y_tar = np.asarray(y_src), np.asarray(y_tar)
    x_src, x_tar = np.asarray(x_src), np.asarray(x_tar)
    train_mask_tar = np.asarray(train_mask_tar)
    pred_src = np.asarray(probs_clf_src).argmax(1)
    pred_tar = np.asarray(probs_clf_tar).argmax(1)
    e0, e1 = edge_index[0], edge_index[1]
    remove = np.zeros(edge_index.shape[1], dtype=bool)
    e_sim = np.asarray(e_sim).reshape(-1)

    # 1. low similarity-confidence edges (quantile threshold)
    remove[e_sim < np.quantile(e_sim, thres_conf_quantile)] = True
    # 2. endpoints whose predicted label contradicts the training label
    remove[pred_src[e0] != y_src[e0]] = True
    remove[(pred_tar[e1] != y_tar[e1]) & train_mask_tar[e1]] = True
    # 3. endpoints predicted differently
    remove[pred_src[e0] != pred_tar[e1]] = True
    # 4. low raw-feature cosine similarity
    num = (x_src[e0] * x_tar[e1]).sum(1)
    den = np.maximum(
        np.linalg.norm(x_src[e0], axis=1) * np.linalg.norm(x_tar[e1], axis=1),
        1e-8)
    remove[num / den < thres_feat_sim] = True
    if verbose:
        print(f"cross filters removed {remove.sum()}/{len(remove)}")
    return edge_index[:, ~remove]


def check_within_validity(
    edge_index: np.ndarray, e_sim: np.ndarray, y: np.ndarray, x: np.ndarray,
    train_mask: np.ndarray, probs_clf: np.ndarray,
    thres_conf_quantile: float = 0.1, thres_feat_sim: float = 0.8,
    verbose: bool = False,
) -> np.ndarray:
    """The within-domain filters (main_bridged_graph.py:123-161). The
    reference's quirk is kept: filter 2 gates both endpoint checks on the
    destination's train membership (:140-141)."""
    y, x, train_mask = np.asarray(y), np.asarray(x), np.asarray(train_mask)
    pred = np.asarray(probs_clf).argmax(1)
    e0, e1 = edge_index[0], edge_index[1]
    remove = np.zeros(edge_index.shape[1], dtype=bool)
    e_sim = np.asarray(e_sim).reshape(-1)

    remove[e_sim < np.quantile(e_sim, thres_conf_quantile)] = True
    remove[(pred[e0] != y[e0]) & train_mask[e1]] = True
    remove[(pred[e1] != y[e1]) & train_mask[e1]] = True
    remove[pred[e0] != pred[e1]] = True
    num = (x[e0] * x[e1]).sum(1)
    den = np.maximum(
        np.linalg.norm(x[e0], axis=1) * np.linalg.norm(x[e1], axis=1), 1e-8)
    remove[num / den < thres_feat_sim] = True
    if verbose:
        print(f"within filters removed {remove.sum()}/{len(remove)}")
    return edge_index[:, ~remove]


def _graph_to_dict(g: Graph) -> Dict[str, np.ndarray]:
    n = g.num_nodes
    return dict(
        x=_np(g.x)[:n], y=_np(g.y)[:n], edge_index=g.edge_index_np(),
        train_mask=_np(g.train_mask)[:n], val_mask=_np(g.val_mask)[:n],
        test_mask=_np(g.test_mask)[:n],
    )


def gen_bridged_graph(
    model, g_src: Graph, adj_src, g_tar: Graph, adj_tar,
    mapper_idx_src: Dict[int, int], mapper_idx_tar: Dict[int, int],
    k_cross: int = 20, k_within: int = 0,
    check_cross: bool = False, check_within: bool = False,
    thres_conf_quantile: float = 0.1, thres_feat_sim: float = 0.0,
    sim_mode: str = "mlp", epsilon: float = 0.5, row_block: int = 512,
    verbose: bool = False, approx_recall=None, rerank_candidates=None,
    reference_compat: bool = False, timings: Optional[dict] = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """The bridge build end to end (reference main_bridged_graph.py:
    267-321) from ``model``'s weights, on the device its graphs and
    adjacencies lie on: the merged and reordered graph dict, ready for
    stage 2 or ``save_graph_npz``.

    ``timings``, where given, gets the seconds of each part on the host
    clock, the device synchronized around each: ``encode`` (both
    domains), ``cross_topk``, ``within_source`` and ``within_target``
    (each with its domain's encode) and ``filters_merge``.

    ``mesh``: a process group whose every rank makes this call with the
    same model and graphs; the top-ks split their columns over its ranks
    and each rank returns the same graph."""
    dev = g_src.x.device
    ei_cross, sims, p_src, p_tar, homo = propose_cross_edges(
        model, g_src, adj_src, g_tar, adj_tar, k_cross,
        row_block=row_block, sim_mode=sim_mode, epsilon=epsilon,
        approx_recall=approx_recall, rerank_candidates=rerank_candidates,
        timings=timings, mesh=mesh)
    if verbose:
        print(f"cross proposals: {ei_cross.shape[1]} (homophily "
              f"{homo:.4f})")
    within = {}
    if k_within > 0:
        for domain, g, adj in (("source", g_src, adj_src),
                               ("target", g_tar, adj_tar)):
            with _timed(timings, f"within_{domain}", dev):
                within[domain] = propose_within_edges(
                    model, g, adj, domain, k_within, row_block=row_block,
                    sim_mode=sim_mode, approx_recall=approx_recall,
                    rerank_candidates=rerank_candidates, mesh=mesh)
    with _timed(timings, "filters_merge", dev):
        src_d = _graph_to_dict(g_src)
        tar_d = _graph_to_dict(g_tar)
        if reference_compat:
            # reference order: coalesce (a sort) first (:75), then the
            # filters with the row-major sim vector (:235-239)
            ei_cross = _pyg_coalesce_order(ei_cross)
        if check_cross:
            ei_cross = check_cross_validity(
                ei_cross, sims, src_d["y"], tar_d["y"], src_d["x"],
                tar_d["x"], tar_d["train_mask"], p_src, p_tar,
                thres_conf_quantile, thres_feat_sim, verbose)
        ei_cross = coalesce_np(
            ei_cross, max(g_src.num_nodes, g_tar.num_nodes) + 1)
        ei_within = {"source": None, "target": None}
        for domain, d, probs in (("source", src_d, p_src),
                                 ("target", tar_d, p_tar)):
            if domain not in within:
                continue
            ei, e_sim = within[domain]
            if reference_compat:
                # the reference coalesces within proposals inside the
                # proposer (:113), before the checks
                ei = _pyg_coalesce_order(ei)
            if check_within:
                # the reference call site's fixed thresholds (:302-306)
                ei = check_within_validity(
                    ei, e_sim, d["y"], d["x"], d["train_mask"], probs,
                    0.1, 0.8, verbose)
            ei_within[domain] = coalesce_np(ei, d["x"].shape[0])
        src_d["central_mask"] = np.ones(g_src.num_nodes, dtype=bool)
        tar_d["central_mask"] = np.zeros(g_tar.num_nodes, dtype=bool)
        merged = merge_graphs_np(src_d, tar_d, ei_cross.copy(),
                                 ei_within["source"], ei_within["target"])
        out = reorder_np(merged, g_src.num_nodes, mapper_idx_src,
                         mapper_idx_tar)
    return out
