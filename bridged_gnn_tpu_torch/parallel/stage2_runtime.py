"""Multi-device backends of the stage-2 trainer.

Port of ``bridged_gnn_tpu/parallel/stage2_runtime.py``. With
``Stage2Config.n_shards > 1`` the trainer (``train/stage2.py``) runs its
own epoch loop, eval heads, best-by-``loss_clf_t2`` selection,
checkpoints and numerics guards on one rank per shard, each through a
backend with the single device's calls (``train/stage2.py::Stage2Backend``,
which it subclasses): the loss and its terms, the scores and the counts
are the whole graph's, and ``info()`` gives the layout and its figures.

Layouts: ``halo`` (:class:`HaloStage2Backend`, row partition + boundary
exchange, ``halo_overlap`` for the overlap form unless the model
recomputes its convs, ``memory_policy="lean"``) and ``edgeshard``
(:class:`EdgeShardStage2Backend`). ``KTGNN`` and ``KTGNN_noDTC`` run on
either.

Gradients. Each rank runs the forward and backward of its own share of
the loss and then all-reduces the parameter gradients once (SUM). Halo:
a rank's share is the loss terms' sums over its own rows divided by the
global counts (all-reduced once, when the backend is built), so the
shares sum to the loss; the collectives inside the forward differentiate
as the sum of their cotangents (``parallel/collectives.py``). Edge shard:
every rank holds the whole loss (node arrays are replicated) and
backpropagates a ``1/n`` share of it. Parameters, Adam's state, the
batch-norm statistics and the dropout generator then stay bit-identical
on every rank.

Scores. With ``metric`` "f1" (``f1_average`` "macro" or "binary") or
"acc", each rank counts the five confusion tables of scan mode
(``train/metrics.py::TABLES``) over its rows and the counts are
all-reduced (replicated under the edge shard): every rank scores the
same counts, as ``score_from_counts`` does. Any other metric gathers the
predictions (and probabilities) of all rows to every rank and scores
them as the single-device trainer does.

Scan mode (JAX ``scan_chunk`` of both backends) runs the trainer's
epoch body over the backend's ``train_step`` and ``eval_counts``. Under
NCCL the epoch is captured in a CUDA graph after the eager warm-up
epochs and replayed; under gloo every epoch runs eagerly (the trainer
fixes the rule from the group's backend before the run). Nothing in a
step re-binds storage between replays: the gradients are all-reduced in
one flat buffer allocated with the backend, and ``p.grad`` are views of
it.

JAX's ``estimate_plain_hbm_per_shard`` is not ported: the port's
``memory_policy="auto"`` reads no estimate (``resolve_memory_policy``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.graph import Graph
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.parallel.collectives import GradAllReduce
from bridged_gnn_tpu_torch.parallel.gspmd import gspmd_setup
from bridged_gnn_tpu_torch.parallel.halopart import (
    HaloPartition,
    build_halo_partition,
    halo_view,
    shard_edges,
    shard_node_array,
    wire_bytes_per_layer,
)
from bridged_gnn_tpu_torch.train.metrics import (
    counts_can_score,
    score_arrays,
    table_scores,
)
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Backend,
    kl_sum,
    ktgnn_loss,
)
from bridged_gnn_tpu_torch.utils.profiling import collective_span


def _nll_sum(lp, y, mask):
    picked = lp.gather(1, y.clamp(min=0).long()[:, None])[:, 0]
    return -(picked * mask.to(lp.dtype)).sum()


class _Backend(Stage2Backend):
    """What sharding changes of the single device's backend: the loss over
    ``counts`` (the global counts of the train rows, the target train rows
    and the real rows) and the gradients' all-reduce, the tables'
    all-reduce, the arrays' gather. Subclasses give the rank's ``g``,
    ``adj`` and ``inputs`` and set ``replicated`` (every rank holds every
    row)."""

    replicated: bool = False
    halo: Any = None  # the halo view, the halo layout's model input

    def __init__(self, group, device, model, g: Graph, adj, inputs, cfg,
                 num_classes: int):
        self.group, self.device = group, torch.device(device)
        self.n = dist.get_world_size(group)
        self.multi_head = isinstance(model, KTGNN)
        self.all_reduce_grads = GradAllReduce(model.parameters(), group)
        self.g = g
        self.counts = self._global_counts()
        super().__init__(model, g, adj, inputs, cfg, num_classes)

    def _global_counts(self):
        g = self.g
        c = torch.stack([g.train_mask.sum(), (g.train_mask
                                              & ~g.central_mask).sum(),
                         g.node_mask.sum()]).double()
        if not self.replicated:
            with collective_span("all_reduce"):
                dist.all_reduce(c, op=dist.ReduceOp.SUM, group=self.group)
        return c.clamp(min=1.0).float()

    def _terms(self, generator):
        """This rank's share of the loss and of each term."""
        g, (n_tm, n_tt, n_nm) = self.g, self.counts
        lp_s, lp_t, lp_that = self.heads(generator)
        loss_s = _nll_sum(lp_s, g.y, g.train_mask) / n_tm
        if not self.multi_head:
            return loss_s, dict(loss_s=loss_s, loss_t1=loss_s,
                                loss_t2=loss_s,
                                loss_kl=torch.zeros_like(loss_s))
        tt = g.train_mask & ~g.central_mask
        aux = dict(loss_s=loss_s,
                   loss_t1=_nll_sum(lp_t, g.y, tt) / n_tt,
                   loss_t2=_nll_sum(lp_that, g.y, tt) / n_tt,
                   loss_kl=kl_sum(lp_that, lp_t, g.node_mask) / n_nm)
        return ktgnn_loss(aux, self.cfg.Lambda), aux

    def train_step(self, opt: torch.optim.Optimizer,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One optimizer step; the loss and its terms, of the whole graph,
        at the parameters before the step."""
        self.model.train()
        opt.zero_grad(set_to_none=True)
        loss, aux = self._terms(generator)
        (loss / self.n if self.replicated else loss).backward()
        self.all_reduce_grads()
        opt.step()
        keys = ("loss_s", "loss_t1", "loss_t2", "loss_kl")
        vals = torch.stack([loss.detach()] + [aux[k].detach() for k in keys])
        if not self.replicated:
            with collective_span("all_reduce"):
                dist.all_reduce(vals, op=dist.ReduceOp.SUM,
                                group=self.group)
        return vals[0], dict(zip(keys, vals[1:]))

    def eval_counts(self) -> torch.Tensor:
        """The tables of this rank's rows, summed over the ranks."""
        counts = super().eval_counts()
        if not self.replicated:
            with collective_span("all_reduce"):
                dist.all_reduce(counts, op=dist.ReduceOp.SUM,
                                group=self.group)
        return counts

    def evaluate(self):
        metric, average = self.cfg.metric, self.cfg.f1_average
        if counts_can_score(metric, average):
            return table_scores(self.eval_counts().cpu().numpy(), metric,
                                average)
        local = [*self._eval_arrays(need_probs=True), self.y_np,
                 *self.masks_np.values()]
        if not self.replicated:
            parts = [None] * self.n
            dist.all_gather_object(parts, local, group=self.group)
            local = [np.concatenate(a, axis=-1) for a in zip(*parts)]
        preds, probs, y, *masks = local
        return score_arrays(preds, probs, y, dict(zip(
            ("train", "val", "test"), masks)), metric, average)

    def info(self) -> Dict[str, Any]:
        return dict(layout=self.layout, n_shards=self.n,
                    backend=dist.get_backend(self.group))


class HaloStage2Backend(_Backend):
    """The halo row partition (``parallel/halopart.py``): this rank's
    rows of every node array and the edges into them, the shard's slot
    layouts, and the boundary exchange per conv. ``part`` may be passed
    (built once with ``build_halo_partition``); else it is built here
    from ``g`` (host)."""

    layout = "halo"

    def __init__(self, group, device, model, g: Graph, cfg,
                 num_classes: int, part: Optional[HaloPartition] = None):
        n, dev = dist.get_world_size(group), torch.device(device)
        # JAX takes the overlap form only without recompute-backward
        # (nn/ktgnn.py:428-429), and a sharded lean KT-GNN recomputes: a
        # model whose convs recompute in the backward runs the plain
        # exchange and the attention kernels, whatever halo_overlap says
        overlap = cfg.halo_overlap and not getattr(model, "remat", False)
        part = part or build_halo_partition(
            g, n, overlap=overlap, node_block=cfg.halo_node_block)
        self.part = part = part if overlap else part._replace(pl2=None)
        if part.num_shards != n:
            raise ValueError(f"the partition has {part.num_shards} shards, "
                             f"the group {n} ranks")
        q = dist.get_rank(group)
        self.halo = halo_view(part, group, dev,
                              selective=not isinstance(model, KTGNN))

        def rows(t, fill=0):
            a = shard_node_array(t.cpu().numpy(), part, q, fill)
            return torch.from_numpy(a).to(dev)

        r, s, m = shard_edges(part, q)
        shard = Graph(
            x=rows(g.x), y=rows(g.y, -1),
            senders=torch.from_numpy(s).to(dev),
            receivers=torch.from_numpy(r).to(dev),
            edge_mask=torch.from_numpy(m).to(dev),
            node_mask=rows(g.node_mask, False),
            train_mask=rows(g.train_mask, False),
            val_mask=rows(g.val_mask, False),
            test_mask=rows(g.test_mask, False),
            central_mask=rows(g.central_mask, False),
            num_nodes=part.rows, num_edges=int(m.sum()))
        super().__init__(group, dev, model, shard, None,
                         dict(halo=self.halo), cfg, num_classes)

    def info(self) -> Dict[str, Any]:
        p = self.part
        st = self.halo.stats
        return dict(
            super().info(), overlap=self.halo.overlap, rows=p.rows,
            ext_len=p.ext_len, h_pair=p.h_pair, e_shard=p.e_shard,
            node_block=p.block_node_block, pd_tile=p.pd_tile,
            halo_rows=p.halo_rows_real,
            wire_bytes_per_layer=wire_bytes_per_layer(p, self.cfg.hidden),
            exchange=dict(calls=st.calls, bytes=st.bytes, s=st.seconds,
                          stage_s=st.stage_seconds,
                          staged=self.halo.stage_on_host))


class EdgeShardStage2Backend(_Backend):
    """The edge-shard layout (``parallel/edgeshard.py``): the whole graph
    on every rank, this rank's span of the edges in its adjacency."""

    layout = "edgeshard"
    replicated = True

    def __init__(self, group, device, model, g: Graph, cfg,
                 num_classes: int):
        shard, adj = gspmd_setup(group, g, torch.device(device))
        super().__init__(group, device, model, shard, adj, {}, cfg,
                         num_classes)


def make_stage2_backend(group, device, model, g: Graph, cfg,
                        num_classes: int,
                        part: Optional[HaloPartition] = None) -> _Backend:
    """The backend ``cfg.shard_layout`` names, on this rank of ``group``
    (``g``: the whole training graph, on the host)."""
    if cfg.shard_layout == "halo":
        return HaloStage2Backend(group, device, model, g, cfg, num_classes,
                                 part=part)
    if cfg.shard_layout == "edgeshard":
        return EdgeShardStage2Backend(group, device, model, g, cfg,
                                      num_classes)
    raise ValueError(f"shard_layout: {cfg.shard_layout!r}")
