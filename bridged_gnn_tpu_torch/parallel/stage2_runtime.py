"""Multi-device backends of the stage-2 trainer.

Port of ``bridged_gnn_tpu/parallel/stage2_runtime.py``. With
``Stage2Config.n_shards > 1`` the trainer (``train/stage2.py``) runs its
own epoch loop, eval heads, best-by-``loss_clf_t2`` selection,
checkpoints and numerics guards on one rank per shard, each with a
backend that gives it two calls:

* ``train_step(opt, generator)`` → ``(loss, aux)``: one optimizer step;
  the loss and its terms of the whole graph (0-dim tensors);
* ``evaluate()`` → ``(scores, per_head)``: the eval heads' scores on
  the whole graph;
* ``eval_counts()`` → the five confusion tables of scan mode, summed over
  the ranks and left on the device: the eval half of a sharded scan
  epoch (``train/stage2.py::_epoch_body``), which a CUDA graph captures.

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
(``train/stage2.py::_TABLES``) over its rows and the counts are
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
from bridged_gnn_tpu_torch.utils.profiling import collective_span


def _counts_score(cfg) -> bool:
    """Whether the confusion counts can score ``cfg``'s metric."""
    return (cfg.metric in ("f1", "acc")
            and cfg.f1_average in ("macro", "binary"))


def _nll_sum(lp, y, mask):
    picked = lp.gather(1, y.clamp(min=0).long()[:, None])[:, 0]
    return -(picked * mask.to(lp.dtype)).sum()


def _kl_sum(log_q, log_p, mask):
    kl = torch.exp(log_p) * (log_p - log_q)
    return (kl * mask.to(log_q.dtype)[:, None]).sum()


class _Backend:
    """What both layouts share: the step, the loss terms, the scores.
    Subclasses set ``g`` (the rank's graph on its device), ``adj`` and
    ``halo`` (the model's inputs), ``counts`` (the global counts of the
    train rows, the target train rows and the real rows) and
    ``replicated`` (every rank holds every row)."""

    g: Graph
    adj: Any = None
    halo: Any = None
    replicated: bool = False

    def __init__(self, group, device, model, cfg, num_classes: int):
        from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN

        self.group, self.device, self.model, self.cfg = (
            group, torch.device(device), model, cfg)
        self.n = dist.get_world_size(group)
        self.multi_head = isinstance(model, KTGNN)
        self.num_classes = num_classes
        self.all_reduce_grads = GradAllReduce(model.parameters(), group)

    def _setup(self) -> None:
        """What subclasses call once ``g`` is set: the global counts of
        the loss and the five tables' masks and label bins."""
        from bridged_gnn_tpu_torch.train.stage2 import _TABLES

        g, c = self.g, self.num_classes
        self.counts = self._global_counts()
        splits = torch.stack([g.train_mask, g.val_mask, g.test_mask]).int()
        self.table_masks = splits[[m for _, m in _TABLES]]
        self.y_bin = torch.where(g.y < 0, c, g.y).long()

    def _heads(self, generator=None):
        out = self.model(self.g, self.adj, generator, halo=self.halo)
        return out[:3] if isinstance(out, tuple) else (out,) * 3

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
        lp_s, lp_t, lp_that = self._heads(generator)
        loss_s = _nll_sum(lp_s, g.y, g.train_mask) / n_tm
        if not self.multi_head:
            return loss_s, dict(loss_s=loss_s, loss_t1=loss_s,
                                loss_t2=loss_s,
                                loss_kl=torch.zeros_like(loss_s))
        tt = g.train_mask & ~g.central_mask
        aux = dict(loss_s=loss_s,
                   loss_t1=_nll_sum(lp_t, g.y, tt) / n_tt,
                   loss_t2=_nll_sum(lp_that, g.y, tt) / n_tt,
                   loss_kl=_kl_sum(lp_that, lp_t, g.node_mask) / n_nm)
        loss = ((2.0 * aux["loss_s"] + aux["loss_t1"] + aux["loss_t2"]) / 4.0
                + self.cfg.Lambda * aux["loss_kl"])
        return loss, aux

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
        """The five confusion tables of the eval heads
        (``train/stage2.py::_TABLES``) [5, 3, C+1] int64, summed over the
        ranks, on the device: nothing waits for it, so a CUDA graph
        captures it under NCCL."""
        from bridged_gnn_tpu_torch.train.stage2 import (
            _TABLES,
            _confusion_counts,
        )

        self.model.eval()
        with torch.no_grad():
            heads = self._heads()
            preds = torch.stack([heads[h].argmax(1) for h, _ in _TABLES])
            counts = _confusion_counts(preds, self.table_masks, self.y_bin,
                                       self.num_classes + 1)
            if not self.replicated:
                with collective_span("all_reduce"):
                    dist.all_reduce(counts, op=dist.ReduceOp.SUM,
                                    group=self.group)
        return counts

    def evaluate(self):
        """``(scores, per_head)`` of the eval heads (source head on train,
        target-hat on val and test; each head on test), as the
        single-device trainer's."""
        from bridged_gnn_tpu_torch.train.stage2 import (
            _table_scores,
            score_arrays,
        )

        if _counts_score(self.cfg):
            return _table_scores(self.eval_counts().cpu().numpy(), self.cfg)
        self.model.eval()
        g = self.g
        with torch.no_grad():
            heads = self._heads()
            preds = torch.stack([lp.argmax(1) for lp in heads])
            splits = [g.train_mask, g.val_mask, g.test_mask]
            probs = torch.stack([lp[:, 1].exp() for lp in heads])
            local = [t.cpu().numpy() for t in (preds, probs, g.y, *splits)]
        if not self.replicated:
            parts = [None] * self.n
            dist.all_gather_object(parts, local, group=self.group)
            local = [np.concatenate(a, axis=-1) for a in zip(*parts)]
        preds, probs, y, *masks = local
        return score_arrays(preds, probs, y, dict(zip(
            ("train", "val", "test"), masks)), self.cfg)

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
        super().__init__(group, device, model, cfg, num_classes)
        # JAX takes the overlap form only without recompute-backward
        # (nn/ktgnn.py:428-429), and a sharded lean KT-GNN recomputes: a
        # model whose convs recompute in the backward runs the plain
        # exchange and the attention kernels, whatever halo_overlap says
        overlap = cfg.halo_overlap and not getattr(model, "remat", False)
        part = part or build_halo_partition(
            g, self.n, overlap=overlap, node_block=cfg.halo_node_block)
        self.part = part = part if overlap else part._replace(pl2=None)
        if part.num_shards != self.n:
            raise ValueError(f"the partition has {part.num_shards} shards, "
                             f"the group {self.n} ranks")
        q = dist.get_rank(group)
        self.halo = halo_view(part, group, self.device,
                              selective=not self.multi_head)
        dev = self.device

        def rows(t, fill=0):
            a = shard_node_array(t.cpu().numpy(), part, q, fill)
            return torch.from_numpy(a).to(dev)

        r, s, m = shard_edges(part, q)
        self.g = Graph(
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
        self._setup()

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
        super().__init__(group, device, model, cfg, num_classes)
        self.g, self.adj = gspmd_setup(group, g, self.device)
        self._setup()


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
