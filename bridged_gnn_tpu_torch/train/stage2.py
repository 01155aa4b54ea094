"""Stage-2 training runtime: KT-GNN knowledge transfer on a bridged graph.

Port of ``bridged_gnn_tpu/train/stage2.py`` on one device (reference
main_graph_knowledge_transfer.py:39-262), for KT-GNN, KTGNN_noDTC and
the model zoo (``nn/backbones.py``). For KT-GNN:

  * 4-term loss ``(2·L_s + L_t + L_t̂)/4 + λ·KL(t̂ ‖ t)`` with the KL in
    torch ``kl_div(log_t̂, log_t, log_target=True, reduction='batchmean')``
    convention (lines 43-54);
  * Adam(lr 1e-3, wd 5e-3, torch L2 semantics) + StepLR(100, 0.1)
    (lines 205-207);
  * model selection by **minimum loss_clf_t2** (line 238), not val metric;
  * eval: source head on the train mask; distilled target-hat head on
    val/test (lines 73-118); per-head test scores (lines 119-142).

A single-head model (``KTGNN_noDTC``, ``no_dtc=True`` with KTGNN, or a
zoo model) trains on ``masked_nll`` over the train mask alone, with every
loss term of the history equal to it and a KL of 0, is selected by that
loss, and scores its one head everywhere (JAX ``stage2.py:626-629``).

Each epoch is one train step (forward in train mode, loss, backward
through the attention kernels' autograd Functions, Adam, StepLR) and one
eval forward. The per-epoch loop brings the loss and the predictions to
the host every epoch. Scan mode (``scan_epochs > 0``, JAX
``stage2.py:665-716,890-968``) runs :func:`_epoch_body` k epochs per host
round trip: on the card the body is captured once in a CUDA graph and
replayed, each epoch leaves its losses and five confusion-count tables in
a device buffer, and the host scores them after one copy per chunk.
``message_dtype="bfloat16"`` runs the convs' message tables in bf16 (the
kernels' bf16 instantiations) and ``matmul_precision`` is set around the
whole run (JAX ``stage2.py:410-429``): ``"default"`` with bf16 messages
and scan mode is the JAX package's production recipe
(``config.py:80-96``). Options of the JAX ``Stage2Config`` that the port
does not run yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import (
    Graph,
    coalesce_np,
    graph_from_dict,
    with_self_loops,
)
from bridged_gnn_tpu_torch.nn.backbones import MODEL_NAMES, build_backbone
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN, MSG_DTYPES, KTGNNNoDTC
from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, adjacency_from_graph
from bridged_gnn_tpu_torch.train.metrics import eval_metric, score_from_counts
from bridged_gnn_tpu_torch.train.optim import (
    load_optimizer_state,
    make_optimizer,
)
from bridged_gnn_tpu_torch.utils.platform import (
    check_matmul_precision,
    matmul_precision,
    resolve_device,
)
from bridged_gnn_tpu_torch.utils.profiling import EpochTimer
from bridged_gnn_tpu_torch.utils.sanitizers import assert_all_finite


@dataclasses.dataclass
class Stage2Config:
    model_name: str = "KTGNN"
    num_layer: int = 2
    hidden: int = 64
    num_epoch: int = 300
    lr: float = 1e-3
    weight_decay: float = 5e-3
    use_scheduler: bool = True
    step_size: int = 100
    gamma: float = 0.1
    Lambda: float = 1.0
    dropout: float = 0.5
    use_bn: bool = True
    root_weight: bool = False
    metric: str = "f1"
    f1_average: str = "macro"
    seed: int = 0
    no_dtc: bool = False
    to_undirected: bool = False
    # 'auto' = one padded layout, or degree tiers when the skew rule fires
    adjacency_method: str = "auto"
    log_every: int = 0  # 0 = silent
    ckpt_dir: Optional[str] = None   # enable periodic checkpoints + resume
    ckpt_every: int = 50
    resume: bool = False
    save_best_path: Optional[str] = None  # pickle best-model variables
    need_complement: bool = False   # not ported (see _NOT_PORTED)
    # epochs per host round trip (0 = the per-epoch loop); on the card
    # one CUDA graph of an epoch replayed k times per chunk
    scan_epochs: int = 0
    # "plain" keeps every activation; "lean" recomputes each embedding
    # conv in the backward; "auto" is plain (see resolve_memory_policy)
    memory_policy: str = "auto"
    # raise FloatingPointError on a non-finite loss, parameter or BN
    # statistic, every epoch (loop) or chunk (scan)
    check_numerics: bool = False
    # JAX's matmul precision name around the run: "default" and
    # "bfloat16" run the card's f32 matmuls in TF32 (utils/platform.py)
    matmul_precision: Optional[str] = None
    # the convs' message tables: None (f32) or "bfloat16"
    message_dtype: Optional[str] = None
    # an option of the JAX runtime the port does not run yet; any other
    # value than the default raises (see _NOT_PORTED)
    n_shards: int = 1


# field, the values the port runs, the ROADMAP.md item that brings the rest
_NOT_PORTED = (
    ("model_name", ("KTGNN", "KTGNN_noDTC") + MODEL_NAMES,
     "Queue 1 item 8 (ConvNet/SplineConv)"),
    ("need_complement", (False,), "Queue 1 item 8 (the complementor)"),
    ("adjacency_method", ("auto", "blocked", "tiered"),
     "Queue 1 item 5 (the dense path)"),
    ("n_shards", (1,), "Queue 1 item 9 (multi-device)"),
)


def check_ported(cfg: Stage2Config) -> None:
    """Raise ``NotImplementedError`` for a value the port does not run
    yet, ``ValueError`` for one that no runtime takes."""
    for field, ported, item in _NOT_PORTED:
        value = getattr(cfg, field)
        if value not in ported:
            raise NotImplementedError(
                f"Stage2Config.{field}={value!r} is not ported (the port "
                f"runs {list(ported)}); see ROADMAP.md {item}")
    if cfg.memory_policy == "xla_plain":
        raise NotImplementedError(
            "Stage2Config.memory_policy='xla_plain' (the JAX package's "
            "kernels-off tier) is not ported by design: on the card the "
            "port always runs its kernels, and its plain versions run "
            "only for CPU tensors; see ROADMAP.md Queue 1 item 10")
    if cfg.memory_policy not in ("auto", "plain", "lean"):
        raise ValueError(f"memory_policy: {cfg.memory_policy!r}")
    if cfg.scan_epochs < 0:
        raise ValueError(f"scan_epochs must be >= 0, got {cfg.scan_epochs}")
    if cfg.message_dtype not in MSG_DTYPES:
        raise ValueError(f"message_dtype must be one of {list(MSG_DTYPES)}, "
                         f"got {cfg.message_dtype!r}")
    check_matmul_precision(cfg.matmul_precision)


def masked_nll(log_probs: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean of -log p(y) over masked nodes (torch F.nll_loss semantics)."""
    y_safe = y.clamp(min=0).long()
    picked = log_probs.gather(1, y_safe[:, None])[:, 0]
    m = mask.to(log_probs.dtype)
    return -(picked * m).sum() / m.sum().clamp(min=1.0)


def kl_batchmean(log_q: torch.Tensor, log_p: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """torch F.kl_div(log_q, log_p, log_target=True, reduction='batchmean')
    over masked rows: sum(exp(log_p)·(log_p − log_q)) / num_rows."""
    kl = torch.exp(log_p) * (log_p - log_q)
    num = (kl * mask.to(log_q.dtype)[:, None]).sum()
    return num / mask.sum().clamp(min=1)


def to_undirected_np(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """PyG ToUndirected(merge=True): union of edges and reversed edges,
    coalesced (reference main_graph_knowledge_transfer.py:410-411)."""
    ei = data["edge_index"]
    both = np.concatenate([ei, ei[::-1]], axis=1)
    out = dict(data)
    out["edge_index"] = coalesce_np(both, data["x"].shape[0])
    return out


# Models whose reference counterparts see a self-loop-augmented edge set
# (JAX stage2.py:170-180): KT-GNN's graph partition adds them, PyG
# GCNConv/GCN2 normalize with them, the reference GAT wrappers add them;
# GraphSAGE, MLP, GIN and DeeperGCN aggregate the raw edge set.
SELF_LOOP_MODELS = frozenset(
    {"KTGNN", "KTGNN_noDTC", "GCN", "GAT", "GATv2", "JKNet", "APPNP",
     "GCN2"})


def _ktgnn_family(cfg: Stage2Config) -> bool:
    return cfg.model_name in ("KTGNN", "KTGNN_noDTC")


def _multi_head(cfg: Stage2Config) -> bool:
    """KT-GNN's three heads and four-term loss (JAX ``is_ktgnn``)."""
    return cfg.model_name == "KTGNN" and not cfg.no_dtc


def prepare_stage2_graph(
    data: Dict[str, np.ndarray], cfg: Stage2Config, device="cuda",
) -> Tuple[Graph, Adjacency]:
    """The training graph on ``device`` (self loops added for
    :data:`SELF_LOOP_MODELS`) and its adjacency: for KT-GNN the
    ``node_block=128`` slot layout the predictor serves with, for the zoo
    the JAX package's ``node_block=256`` one, or degree tiers."""
    dev = resolve_device(device)
    data = dict(data)
    # reference quirk kept: unlabeled nodes can never be train
    # (main_graph_knowledge_transfer.py:404)
    data["train_mask"] = np.asarray(data["train_mask"]).copy()
    data["train_mask"][np.asarray(data["y"]) == -1] = False
    if cfg.to_undirected:
        data = to_undirected_np(data)
    g = graph_from_dict(data)
    if cfg.model_name in SELF_LOOP_MODELS:
        g = with_self_loops(g)
    g = g.to(dev)
    method = ("blocked" if cfg.adjacency_method == "auto"
              else cfg.adjacency_method)
    adj = adjacency_from_graph(
        g, method=method, node_block=128 if _ktgnn_family(cfg) else 256,
        device=dev)
    return g, adj


def build_model(cfg: Stage2Config, num_classes: int, in_channels: int,
                device="cuda", remat: bool = False) -> torch.nn.Module:
    """The model ``cfg`` names, as JAX ``_build_model_impl`` picks it
    (stage2.py:376-417), with its init drawn from ``cfg.seed``, on
    ``device``: ``KTGNNNoDTC`` for ``model_name="KTGNN_noDTC"`` or
    ``no_dtc=True`` with KTGNN, KT-GNN, or a zoo model. ``remat``
    recomputes KT-GNN's embedding convs in the backward
    (``memory_policy="lean"``); ``cfg.message_dtype`` sets the KT-GNN
    family's message dtype and is refused for the zoo."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model_name == "KTGNN_noDTC" or (
            cfg.no_dtc and cfg.model_name == "KTGNN"):
        model = KTGNNNoDTC(
            num_classes, in_channels, layer_num=cfg.num_layer,
            hidden=cfg.hidden, root_weight=cfg.root_weight,
            dropout=cfg.dropout, use_bn=cfg.use_bn,
            msg_dtype=cfg.message_dtype, generator=gen)
    elif cfg.model_name == "KTGNN":
        model = KTGNN(
            num_classes=num_classes,
            in_channels=in_channels,
            layer_num=cfg.num_layer,
            hidden=cfg.hidden,
            dropout=cfg.dropout,
            use_bn=cfg.use_bn,
            remat=remat,
            root_weight=cfg.root_weight,
            msg_dtype=cfg.message_dtype,
            generator=gen,
        )
    else:
        if cfg.message_dtype is not None:
            raise ValueError(
                "message_dtype applies to KTGNN-family models; "
                f"got model_name={cfg.model_name!r}")
        model = build_backbone(cfg.model_name, cfg, num_classes,
                               in_channels, gen)
    return model.to(dev)


def resolve_memory_policy(cfg: Stage2Config) -> str:
    """``"plain"`` or ``"lean"`` for ``cfg.memory_policy``; ``"plain"``
    for every model but KT-GNN, as in the JAX runtime (stage2.py:500-504).
    For KT-GNN ``"auto"`` is plain on every device. On the CPU that is
    the JAX rule (the host pages; JAX ``stage2.py:321-322``). On the card the JAX rule (the
    fastest policy whose step fits 80% of the device) picks plain too:
    chip_smoke.py phases 7 and 15 measured, with
    ``torch.cuda.max_memory_allocated`` on an NVIDIA H100 80GB HBM3
    (700 W), KT-GNN hidden 64 on the 131,072-node bench graph, a plain
    f32 step's peak at 1,990,748,160 bytes, which lean does not lower
    (the per-slot cotangent ``[slots, hidden]`` sets it), and a bf16
    step's at 1,641,013,760, which lean lowers by 15% (PERF.md §7): both
    far below the card's 80 GB."""
    if not _multi_head(cfg) or cfg.memory_policy == "auto":
        return "plain"
    return cfg.memory_policy


def stage2_loss(model: torch.nn.Module, g: Graph, adj: Adjacency,
                lam: float, generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one train-mode forward (dropout from ``generator``,
    batch statistics) and its terms: for KT-GNN ``(2·L_s + L_t + L_t̂)/4
    + λ·KL(t̂ ‖ t)``; for a single-head model the NLL over the train mask,
    which every term repeats, with a KL of 0."""
    model.train()
    if not isinstance(model, KTGNN):
        loss = masked_nll(model(g, adj, generator), g.y, g.train_mask)
        return loss, dict(loss_s=loss, loss_t1=loss, loss_t2=loss,
                          loss_kl=torch.zeros_like(loss))
    lp_s, lp_t, lp_that = model(g, adj, generator)
    tar_train = g.train_mask & ~g.central_mask
    aux = dict(
        loss_s=masked_nll(lp_s, g.y, g.train_mask),
        loss_t1=masked_nll(lp_t, g.y, tar_train),
        loss_t2=masked_nll(lp_that, g.y, tar_train),
        loss_kl=kl_batchmean(lp_that, lp_t, g.node_mask),
    )
    loss = ((2.0 * aux["loss_s"] + aux["loss_t1"] + aux["loss_t2"]) / 4.0
            + lam * aux["loss_kl"])
    return loss, aux


def train_step(model: torch.nn.Module, g: Graph, adj: Adjacency,
               opt: torch.optim.Optimizer, lam: float,
               generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer step on :func:`stage2_loss`. Returns the loss and its
    terms at the parameters before the step."""
    opt.zero_grad(set_to_none=True)
    loss, aux = stage2_loss(model, g, adj, lam, generator)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def _heads(model: torch.nn.Module, g: Graph, adj: Adjacency):
    """Eval-mode log-probabilities of the three heads (source, target,
    target-hat); a single-head model's one head stands for all three."""
    model.eval()
    with torch.no_grad():
        heads = model(g, adj)
    return heads if isinstance(heads, tuple) else (heads,) * 3


def _eval_arrays(model: torch.nn.Module, g: Graph, adj: Adjacency,
                 need_probs: bool):
    """Eval-mode predictions of the three heads on the host, and their
    positive-class probabilities when ``need_probs`` (for auc)."""
    with torch.no_grad():
        heads = _heads(model, g, adj)
        preds = torch.stack([lp.argmax(1) for lp in heads]).cpu().numpy()
        probs = (torch.stack([lp[:, 1].exp() for lp in heads]).cpu().numpy()
                 if need_probs else None)
    return preds, probs


# ---------------------------------------------------------------- scan mode

# Eager epochs before the capture, on the capture's side stream: they
# create Adam's state, cuBLAS's workspace for that stream and the
# allocator's blocks. They are real epochs of the run, scored as the
# others.
WARMUP_EPOCHS = 2
# The five confusion-count tables of an epoch: (head, split) with heads
# 0 source, 1 target, 2 target-hat and splits 0 train, 1 val, 2 test. The
# first three score the splits, the last three the heads on test.
_TABLES = ((0, 0), (2, 1), (2, 2), (0, 2), (1, 2))


def _confusion_counts(preds: torch.Tensor, masks: torch.Tensor,
                      y_bin: torch.Tensor, bins: int) -> torch.Tensor:
    """[T, 3, bins] int64 ``tp``, ``pred`` and ``true`` counts of T
    tables: table t counts the predictions ``preds[t]`` [N] over the rows
    where ``masks[t]`` (int32, 0 or 1) is 1. ``y_bin`` holds each row's
    class, with ``y == -1`` rows in the last bin, which no prediction
    reaches (``score_from_counts``'s layout). As JAX ``stage2.py:665-680``
    computes them: one-hot rows, the mask multiplied in, integer sums
    over the rows; no atomics and nothing that waits for the device."""
    classes = torch.arange(bins, device=y_bin.device)
    true = (y_bin[:, None] == classes).int()                  # [N, bins]
    pred = (preds[:, :, None] == classes).int() * masks[:, :, None]
    return torch.stack([(pred * true).sum(1), pred.sum(1),
                        (masks[:, :, None] * true).sum(1)], 1)


@dataclasses.dataclass
class _ScanRun:
    """What :func:`_epoch_body` reads and writes. Every tensor keeps its
    storage for the whole run, as a CUDA graph's replays need."""

    model: torch.nn.Module
    g: Graph
    adj: Adjacency
    opt: torch.optim.Optimizer
    gen: torch.Generator
    lam: float
    lr: torch.Tensor       # f64 [], Adam's rate for the next epoch
    schedule: bool         # StepLR on
    step_size: int
    gamma: float
    step: torch.Tensor     # int64 [], epochs done
    masks: torch.Tensor    # int32 [5, N]: each table's split mask
    y_bin: torch.Tensor    # int64 [N]: class, y == -1 in bin C
    bins: int              # C + 1
    i: torch.Tensor        # int64 [1]: the record row this epoch writes
    record: torch.Tensor   # f64 [rows, 2 + 15·bins]: loss, loss_t2, counts


def _scan_run(model, g, adj, opt, gen, cfg: Stage2Config, lr: torch.Tensor,
              epochs_done: int) -> _ScanRun:
    dev = g.x.device
    c = g.num_classes
    splits = torch.stack([g.train_mask, g.val_mask, g.test_mask]).int()
    return _ScanRun(
        model=model, g=g, adj=adj, opt=opt, gen=gen, lam=cfg.Lambda,
        lr=lr, schedule=cfg.use_scheduler, step_size=cfg.step_size,
        gamma=cfg.gamma,
        step=torch.tensor(epochs_done, dtype=torch.int64, device=dev),
        masks=splits[[m for _, m in _TABLES]],
        y_bin=torch.where(g.y < 0, c, g.y).long(), bins=c + 1,
        i=torch.zeros(1, dtype=torch.int64, device=dev),
        record=torch.zeros(cfg.scan_epochs, 2 + len(_TABLES) * 3 * (c + 1),
                           dtype=torch.float64, device=dev))


def _epoch_body(run: _ScanRun) -> None:
    """One epoch of scan mode, on tensors only (JAX ``stage2.py:682-716``):
    the train step (dropout from the run's generator), Adam, StepLR's
    step computed on the device, the eval forward, the three heads'
    argmax and the five confusion tables; the losses and the tables go to
    row ``i`` of the record, and ``i`` advances. Nothing in it waits for
    the device, so a CUDA graph can capture it."""
    loss, aux = train_step(run.model, run.g, run.adj, run.opt, run.lam,
                           run.gen)
    run.step += 1
    if run.schedule:
        # StepLR's own chained product, so the rate is the float the
        # per-epoch loop's scheduler holds, bit for bit
        run.lr.copy_(torch.where(run.step % run.step_size == 0,
                                 run.lr * run.gamma, run.lr))
    heads = _heads(run.model, run.g, run.adj)
    preds = torch.stack([heads[h].argmax(1) for h, _ in _TABLES])
    counts = _confusion_counts(preds, run.masks, run.y_bin, run.bins)
    row = torch.cat([torch.stack([loss, aux["loss_t2"]]).double(),
                     counts.reshape(-1).double()])
    run.record.index_copy_(0, run.i, row[None])
    run.i += 1


def _capture(run: _ScanRun, stream: torch.cuda.Stream):
    """One epoch captured in a CUDA graph on ``stream``, the dropout
    generator registered with it; and the kernel launches each replay
    makes, by wrapper and width. A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(run.gen)
    before = fused_kernels.launch_counts()
    with torch.cuda.graph(graph, stream=stream):
        _epoch_body(run)
    per_replay = {}
    for name, by_d in fused_kernels.launch_counts().items():
        diff = {d: n - before[name].get(d, 0) for d, n in by_d.items()
                if n != before[name].get(d, 0)}
        if diff:
            per_replay[name] = diff
    return graph, per_replay


# One capture stream per device for the whole process. cuBLAS keeps a
# workspace (65 MiB on an H100) for every stream it has run on, and frees
# none, so a new stream per run would leave one behind after each run.
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _use_scan(cfg: Stage2Config) -> bool:
    """The JAX rule (``stage2.py:890-895``): scan needs counts-based
    scores and no per-epoch best-weights copy."""
    return (cfg.scan_epochs > 0 and cfg.metric in ("f1", "acc")
            and cfg.f1_average in ("macro", "binary")
            and cfg.save_best_path is None)


# -------------------------------------------------------------- the trainer


def train_ktgnn(
    data: Dict[str, np.ndarray],
    cfg: Optional[Stage2Config] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Full stage-2 run on ``device``. Returns best scores, the history,
    timing diagnostics, the final weights (``state_dict``, on the CPU),
    the memory policy run and, in scan mode, ``scan``: the eager epochs,
    the captures and replays, and each replay's kernel launches.

    ``max_logit_spread`` is 0.0, as the JAX runtime returns it when its
    probe does not run: that probe guards the TPU kernels' block-max
    softmax shift, and the port's kernels shift by each destination's
    own maximum, so there is nothing for it to guard.

    The whole run, scan mode's capture included (cuBLAS picks its kernels
    there), runs under ``matmul_precision(cfg.matmul_precision)``."""
    cfg = cfg or Stage2Config()
    check_ported(cfg)
    with matmul_precision(cfg.matmul_precision):
        return _train_ktgnn(data, cfg, device)


def _train_ktgnn(data: Dict[str, np.ndarray], cfg: Stage2Config,
                 device) -> Dict[str, Any]:
    dev = resolve_device(device)
    g, adj = prepare_stage2_graph(data, cfg, dev)
    num_classes = g.num_classes
    mem_mode = resolve_memory_policy(cfg)
    if mem_mode != "plain" and cfg.log_every:
        print(f"[memory_policy] {mem_mode} engaged (the embedding convs "
              "recompute in the backward)")
    model = build_model(cfg, num_classes, g.num_features, dev,
                        remat=mem_mode == "lean")
    use_scan = _use_scan(cfg)
    # the loop's rate is a float that StepLR steps; scan mode's a tensor
    # that the epoch body sets on the device (capturable Adam on a card)
    lr = (torch.tensor(cfg.lr, dtype=torch.float64, device=dev)
          if use_scan else cfg.lr)
    opt, sched = make_optimizer(
        model.parameters(), lr, cfg.weight_decay,
        cfg.use_scheduler and not use_scan, cfg.step_size, cfg.gamma)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    y_np = g.y.cpu().numpy()
    masks_np = {
        "train": g.train_mask.cpu().numpy(),
        "val": g.val_mask.cpu().numpy(),
        "test": g.test_mask.cpu().numpy(),
    }
    need_probs = cfg.metric == "auc"

    def evaluate():
        preds, probs = _eval_arrays(model, g, adj, need_probs)

        def score(head, mask):
            # probs: positive-class probability for auc (reference
            # main_graph_knowledge_transfer.py:88,102 uses column 1)
            return eval_metric(
                y_np[mask], preds[head][mask], cfg.metric, cfg.f1_average,
                probs_pos=None if probs is None else probs[head][mask])

        # source head for train, distilled target-hat head for val/test
        scores = {split: score(0 if split == "train" else 2, mask)
                  for split, mask in masks_np.items()}
        per_head = {name: score(h, masks_np["test"]) for h, name in
                    enumerate(("source", "target", "target_hat"))}
        return scores, per_head

    def check_numerics(losses, epoch):
        if cfg.check_numerics:
            assert_all_finite(
                {"loss": losses, "params": dict(model.named_parameters()),
                 "batch_stats": dict(model.named_buffers())},
                f"train state at epoch {epoch}")

    best = {"train": 0.0, "val": 0.0, "test": 0.0, "loss": 666.0,
            "epoch": -1}
    best_state = None
    history = []

    def record(epoch, loss, loss_t2, scores, per_head):
        nonlocal best_state
        history.append(dict(epoch=epoch, loss=loss, loss_t2=loss_t2,
                            **scores))
        if cfg.log_every and epoch % cfg.log_every == 0:
            print(
                f"Epoch {epoch:03d} loss {loss:.4f} "
                f"train {scores['train']:.4f} val {scores['val']:.4f} "
                f"test {scores['test']:.4f}"
            )
        if loss_t2 < best["loss"]:
            best.update(
                train=scores["train"], val=scores["val"],
                test=scores["test"], loss=loss_t2, epoch=epoch,
                per_head=per_head,
            )
            if cfg.save_best_path:
                best_state = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}

    start_epoch = 1
    ckptr = None
    if cfg.ckpt_dir:
        from bridged_gnn_tpu_torch.train.checkpoint import TrainCheckpointer

        ckptr = TrainCheckpointer(cfg.ckpt_dir)
        raw = ckptr.restore() if cfg.resume else None
        if raw is not None:
            model.load_state_dict(raw["model"])
            load_optimizer_state(opt, raw["optimizer"], lr)
            gen.set_state(raw["generator"])
            best = raw["best"]
            start_epoch = int(raw["epoch"]) + 1
            if sched is not None:
                sched.last_epoch = start_epoch - 1

    def save(epoch):
        # loop and scan checkpoints are alike: StepLR's state is the
        # rate in the optimizer's and the epoch
        ckptr.save(epoch, dict(
            model=model.state_dict(), optimizer=opt.state_dict(),
            generator=gen.get_state(), best=best, epoch=epoch,
        ))

    t_start = time.time()
    timer = EpochTimer(dev, num_edges=g.num_edges)
    scan_info = None
    if use_scan:
        run = _scan_run(model, g, adj, opt, gen, cfg, lr, start_epoch - 1)
        scan_info = _scan_loop(run, cfg, timer, start_epoch, record,
                               check_numerics, save if ckptr else None)
    else:
        for epoch in range(start_epoch, cfg.num_epoch + 1):
            with timer:
                loss, aux = train_step(model, g, adj, opt, cfg.Lambda, gen)
                if sched is not None:
                    sched.step()
                loss, loss_t2 = float(loss), float(aux["loss_t2"])
                check_numerics(np.asarray(loss), epoch)
                scores, per_head = evaluate()
            record(epoch, loss, loss_t2, scores, per_head)
            if ckptr is not None and (
                epoch % cfg.ckpt_every == 0 or epoch == cfg.num_epoch
            ):
                save(epoch)

    if cfg.save_best_path and best_state is not None:
        from bridged_gnn_tpu_torch.io.flax_weights import (
            flax_variables_from_state_dict,
        )

        with open(cfg.save_best_path, "wb") as f:
            pickle.dump(flax_variables_from_state_dict(model, best_state), f)

    times = timer.times
    if use_scan:
        # the steady mean: the timer's warmup covers the chunks that
        # carried warm-up epochs or the capture
        mean_epoch = float(timer.steady.mean()) if times else 0.0
    else:
        mean_epoch = (float(np.mean(times[2:] if len(times) > 2 else times))
                      if times else 0.0)
    return dict(
        best=best,
        history=history,
        total_time=time.time() - t_start,
        mean_epoch_time=mean_epoch,
        throughput=timer.summary(),
        max_logit_spread=0.0,
        memory_policy=mem_mode,
        scan=scan_info,
        state_dict={k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()},
        num_edges=g.num_edges,
    )


def _scan_loop(run: _ScanRun, cfg: Stage2Config, timer: EpochTimer,
               start_epoch: int, record, check_numerics, save) -> dict:
    """Scan mode's chunk loop (JAX ``stage2.py:896-968``). Each chunk of
    ``k = min(scan_epochs, remaining)`` epochs runs :func:`_epoch_body` k
    times, then makes one synchronize and one copy of its ``[k]`` rows of
    losses and counts; the host scores them, records the epochs, checks
    numerics and checkpoints.

    On the card the first :data:`WARMUP_EPOCHS` epochs run eagerly on a
    side stream, the next is captured there once, and every later epoch
    is a replay of that graph. On the CPU every epoch runs eagerly."""
    dev = run.g.x.device
    on_card = dev.type == "cuda"
    stream = _capture_stream(dev) if on_card else None
    graph, per_replay = None, {}
    eager = replays = 0
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
    with (torch.cuda.stream(stream) if on_card
          else contextlib.nullcontext()):
        epoch = start_epoch
        while epoch <= cfg.num_epoch:
            k = min(cfg.scan_epochs, cfg.num_epoch - epoch + 1)
            captured, eager_before = False, eager
            with timer.chunk(k):
                run.i.zero_()
                for _ in range(k):
                    if not on_card or eager < WARMUP_EPOCHS:
                        with warnings.catch_warnings():
                            # capturable Adam warns when it steps outside
                            # a capture, as the warm-up epochs do
                            warnings.filterwarnings(
                                "ignore", message=".*capturable=True")
                            _epoch_body(run)
                        eager += 1
                        continue
                    if graph is None:
                        graph, per_replay = _capture(run, stream)
                        captured = True
                    graph.replay()
                    replays += 1
                # the chunk's one synchronize and device-to-host copy
                rec = run.record[:k].cpu().numpy()
                check_numerics(rec[:, :2], epoch + k - 1)
            if (epoch == start_epoch or captured
                    or (on_card and eager > eager_before)):
                # the first chunk, and on the card the warm-up epochs and
                # the capture, stay out of the steady statistics
                timer.warmup = len(timer.times)
            counts = rec[:, 2:].reshape(k, len(_TABLES), 3, run.bins)
            for j in range(k):
                sc = [score_from_counts(*counts[j, t], metric=cfg.metric,
                                        f1_average=cfg.f1_average)
                      for t in range(len(_TABLES))]
                record(epoch + j, float(rec[j, 0]), float(rec[j, 1]),
                       dict(train=sc[0], val=sc[1], test=sc[2]),
                       dict(source=sc[3], target=sc[4], target_hat=sc[2]))
            epoch += k
            if save is not None:
                save(epoch - 1)
    if stream is not None:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return dict(eager_epochs=eager, captures=int(graph is not None),
                replays=replays, launches_per_replay=per_replay)
