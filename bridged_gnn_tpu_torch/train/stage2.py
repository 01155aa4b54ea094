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
``need_complement`` runs KT-GNN's feature complementor over frontiers
built once per run, and its ``loss_dist`` joins the loss (JAX
``stage2.py:547-558, 620-623``). ``ConvNet`` reads its
pseudo-coordinates from the data's ``edge_attr`` (the reference's
``data.edge_attr``), and without them raises JAX's ``ValueError``.

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
(``config.py:80-96``). ``adjacency_method="auto"`` resolves by the
padded node count (``ops/spmm.py::resolve_adjacency_method``; the slot
layouts at every size since the H100 measurement), ``"dense"`` and
``"gather"`` run KT-GNN's attention and the SpMMs in plain PyTorch.
``n_shards > 1`` trains KT-GNN or KTGNN_noDTC over that many ranks of a
process group, one per shard (JAX ``stage2.py:457-495``), on the halo
row partition or the edge-shard layout (``parallel/stage2_runtime.py``);
outside a process group :func:`train_ktgnn` starts the ranks itself and
returns rank 0's result. Every run steps and scores through one backend
interface, :class:`Stage2Backend` on one device or its sharded
subclasses; scan mode's segment loop is ``train/scan.py``, shared with
stage 1. A sharded scan run captures its epoch under NCCL and runs every
epoch eagerly under gloo (CPU ranks, or ranks sharing one card), by a
rule fixed from the group's backend before the run, printed in the
``[parallel]`` header and returned in ``scan["capture"]``.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import (
    Graph,
    dst_order,
    graph_from_dict,
    slot_node_block,
    to_undirected_np,
    with_self_loops,
)
from bridged_gnn_tpu_torch.io import native
from bridged_gnn_tpu_torch.nn.backbones import build_backbone
from bridged_gnn_tpu_torch.nn.common import masked_nll
from bridged_gnn_tpu_torch.nn.complementor import (
    build_frontier_edges,
    pad_frontiers,
)
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN, MSG_DTYPES, KTGNNNoDTC
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, adjacency_from_graph
from bridged_gnn_tpu_torch.train.metrics import (
    TABLES,
    confusion_counts,
    counts_can_score,
    score_arrays,
    table_scores,
)
from bridged_gnn_tpu_torch.train.optim import (
    load_optimizer_state,
    make_optimizer,
)
from bridged_gnn_tpu_torch.train.scan import run_scan
from bridged_gnn_tpu_torch.utils.platform import (
    check_matmul_precision,
    matmul_precision,
    resolve_device,
)
from bridged_gnn_tpu_torch.utils.profiling import EpochTimer, annotate
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
    # 'auto' = dense up to ops/spmm.DENSE_MAX_NODES padded nodes, else
    # 'blocked': one padded layout, or degree tiers when the skew rule
    # fires; 'tiered', 'dense' and 'gather' force theirs
    adjacency_method: str = "auto"
    log_every: int = 0  # 0 = silent
    ckpt_dir: Optional[str] = None   # enable periodic checkpoints + resume
    ckpt_every: int = 50
    resume: bool = False
    save_best_path: Optional[str] = None  # pickle best-model variables
    # KT-GNN's feature complementor (reference need_complement; off in
    # every run.sh config): the first dim_share features are observed,
    # complement_step frontiers, and the distribution loss when asked
    need_complement: bool = False
    dim_share: int = 0
    complement_step: int = 1
    use_dist_loss: bool = False
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
    # JAX's compile-time knob (layouts as jit arguments or constants):
    # the port's layouts are always tensors the kernels take, so every
    # value it accepts ("auto", True, False) runs alike
    pass_layouts: "str | bool" = "auto"
    # multi-device training: >1 runs the same loop over that many ranks
    # (parallel/stage2_runtime.py); KTGNN and KTGNN_noDTC only
    n_shards: int = 1
    # "halo" (row partition + boundary all_to_all, wire bytes ∝ edge cut)
    # or "edgeshard" (edge spans, node arrays replicated)
    shard_layout: str = "halo"
    # halo only: start the exchange, then the local attention partials.
    # Its partials run in plain PyTorch around gather_reduce: on an H100
    # an epoch's device time is ~5x the plain halo form's (179 ms against
    # 36 on chip_smoke.py's bench graph), so it loses unless the exchange
    # takes longer than that difference. With memory_policy="lean" KT-GNN
    # runs the plain halo form instead, as the JAX runtime does
    halo_overlap: bool = False
    # halo only: the shards' slot-layout block (None: 128)
    halo_node_block: Optional[int] = None


def check_ported(cfg: Stage2Config) -> None:
    """Raise ``NotImplementedError`` for a value the port does not run
    yet, ``ValueError`` for one that no runtime takes, and ``TypeError``
    for the complementor on a model without it, where the JAX runtime's
    model refuses the frontiers with one."""
    if cfg.n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {cfg.n_shards}")
    if cfg.shard_layout not in ("halo", "edgeshard"):
        raise ValueError(f"shard_layout: {cfg.shard_layout!r}")
    if cfg.n_shards > 1:
        _check_sharded_model(cfg)
    if cfg.memory_policy == "xla_plain":
        raise NotImplementedError(
            "Stage2Config.memory_policy='xla_plain' (the JAX package's "
            "kernels-off tier) is not ported by design: on the card the "
            "port always runs its kernels, and their plain versions run "
            "only for CPU tensors")
    if cfg.memory_policy not in ("auto", "plain", "lean"):
        raise ValueError(f"memory_policy: {cfg.memory_policy!r}")
    if cfg.need_complement and not _multi_head(cfg):
        raise TypeError(
            f"need_complement runs on KTGNN alone; {built_model_name(cfg)} "
            "takes no frontiers")
    if cfg.scan_epochs < 0:
        raise ValueError(f"scan_epochs must be >= 0, got {cfg.scan_epochs}")
    if cfg.pass_layouts not in ("auto", True, False):
        raise ValueError(f"pass_layouts: {cfg.pass_layouts!r}")
    if cfg.message_dtype not in MSG_DTYPES:
        raise ValueError(f"message_dtype must be one of {list(MSG_DTYPES)}, "
                         f"got {cfg.message_dtype!r}")
    check_matmul_precision(cfg.matmul_precision)


def _check_sharded_model(cfg: Stage2Config) -> None:
    if cfg.model_name not in ("KTGNN", "KTGNN_noDTC") \
            or cfg.need_complement:
        raise ValueError(
            "n_shards > 1 supports the KTGNN and KTGNN_noDTC models "
            f"(need_complement=False); got model_name="
            f"{cfg.model_name!r}, need_complement={cfg.need_complement}")


def kl_sum(log_q: torch.Tensor, log_p: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """sum(exp(log_p)·(log_p − log_q)) over masked rows."""
    kl = torch.exp(log_p) * (log_p - log_q)
    return (kl * mask.to(log_q.dtype)[:, None]).sum()


def kl_batchmean(log_q: torch.Tensor, log_p: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """torch F.kl_div(log_q, log_p, log_target=True, reduction='batchmean')
    over masked rows: :func:`kl_sum` / num_rows."""
    return kl_sum(log_q, log_p, mask) / mask.sum().clamp(min=1)


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


def built_model_name(cfg: Stage2Config) -> str:
    """The model :func:`build_model` builds: ``"KTGNN_noDTC"`` for
    ``no_dtc`` with KTGNN, else ``cfg.model_name``."""
    return ("KTGNN_noDTC" if cfg.no_dtc and cfg.model_name == "KTGNN"
            else cfg.model_name)


def prepare_stage2_graph(
    data: Dict[str, np.ndarray], cfg: Stage2Config, device="cuda",
    build_adj: bool = True,
) -> Tuple[Graph, Optional[Adjacency]]:
    """The training graph on ``device`` (self loops added for
    :data:`SELF_LOOP_MODELS`) and its adjacency by
    ``cfg.adjacency_method`` (``"auto"`` resolved by the padded node
    count): for the slot layouts, KT-GNN's ``node_block=128`` one the
    predictor serves with and the zoo's ``node_block=256`` one, or degree
    tiers. ``build_adj=False`` gives None in its place (the sharded
    backends build their own layouts)."""
    dev = resolve_device(device)
    with annotate("stage2.graph"):
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
    if not build_adj:
        return g, None
    with annotate("stage2.layout") as span:
        before = native.call_counts()["gc_sender_csr"]
        adj = adjacency_from_graph(
            g, method=cfg.adjacency_method,
            node_block=slot_node_block(_ktgnn_family(cfg)), device=dev)
        span.counts.update(native_sender_csr=native.call_counts()[
            "gc_sender_csr"] - before)
    return g, adj


def model_inputs(data: Dict[str, np.ndarray], cfg: Stage2Config,
                 g: Graph) -> Dict[str, Any]:
    """What the model's forward takes beside the graph, on ``g``'s
    device: KT-GNN's complementor frontiers, built once from ``g``'s
    edges (JAX ``stage2.py:547-558``), or ConvNet's ``pseudo``, the data's
    ``edge_attr`` in ``g``'s edge order (zero on padded edges); else
    nothing."""
    if cfg.need_complement:
        fronts = build_frontier_edges(
            g.edge_index_np(), g.central_mask.cpu().numpy()[: g.num_nodes],
            step=cfg.complement_step)
        return dict(frontiers=pad_frontiers(fronts, g.num_nodes_padded,
                                            device=g.x.device))
    if cfg.model_name == "ConvNet" and "edge_attr" in data:
        if cfg.to_undirected:
            raise ValueError("ConvNet's edge_attr cannot follow "
                             "to_undirected's merged edges")
        attr = np.asarray(data["edge_attr"], dtype=np.float32)
        order = dst_order(np.asarray(data["edge_index"]), g.num_nodes)
        pseudo = np.zeros((g.num_edges_padded,) + attr.shape[1:],
                          np.float32)
        pseudo[: len(order)] = attr[order]
        return dict(pseudo=torch.from_numpy(pseudo).to(g.x.device))
    return {}


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
            need_complement=cfg.need_complement,
            dim_share=cfg.dim_share,
            step=cfg.complement_step,
            use_dist_loss=cfg.use_dist_loss,
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
    far below the card's 80 GB. An explicit ``"lean"`` for another model
    runs plain, as in JAX, with a warning. A sharded run resolves alike
    (JAX ``stage2.py:471-495``: its per-shard footprint is below the
    single device's; KTGNN_noDTC always plain)."""
    if not _multi_head(cfg):
        if cfg.memory_policy == "lean":
            warnings.warn(
                f"memory_policy='lean' recomputes KT-GNN's embedding convs; "
                f"{built_model_name(cfg)} runs plain", UserWarning,
                stacklevel=2)
        return "plain"
    return "plain" if cfg.memory_policy == "auto" else cfg.memory_policy


def ktgnn_loss(aux: Dict[str, torch.Tensor], lam: float) -> torch.Tensor:
    """KT-GNN's loss from its terms: ``(2·L_s + L_t + L_t̂)/4 + λ·KL``."""
    return ((2.0 * aux["loss_s"] + aux["loss_t1"] + aux["loss_t2"]) / 4.0
            + lam * aux["loss_kl"])


def stage2_loss(model: torch.nn.Module, g: Graph, adj: Adjacency,
                lam: float, generator: Optional[torch.Generator],
                inputs: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one train-mode forward (dropout from ``generator``,
    batch statistics; ``inputs`` from :func:`model_inputs`) and its
    terms: for KT-GNN ``(2·L_s + L_t + L_t̂)/4 + λ·KL(t̂ ‖ t)``, plus the
    complementor's ``loss_dist`` when it gives one; for a single-head
    model the NLL over the train mask, which every term repeats, with a
    KL of 0."""
    model.train()
    inputs = inputs or {}
    if not isinstance(model, KTGNN):
        loss = masked_nll(model(g, adj, generator, **inputs), g.y,
                          g.train_mask)
        return loss, dict(loss_s=loss, loss_t1=loss, loss_t2=loss,
                          loss_kl=torch.zeros_like(loss))
    lp_s, lp_t, lp_that, loss_dist = model(g, adj, generator, **inputs)
    tar_train = g.train_mask & ~g.central_mask
    aux = dict(
        loss_s=masked_nll(lp_s, g.y, g.train_mask),
        loss_t1=masked_nll(lp_t, g.y, tar_train),
        loss_t2=masked_nll(lp_that, g.y, tar_train),
        loss_kl=kl_batchmean(lp_that, lp_t, g.node_mask),
    )
    loss = ktgnn_loss(aux, lam)
    if loss_dist is not None:
        # reference main_graph_knowledge_transfer.py:60-63
        loss = loss + loss_dist
    return loss, aux


def train_step(model: torch.nn.Module, g: Graph, adj: Adjacency,
               opt: torch.optim.Optimizer, lam: float,
               generator: Optional[torch.Generator],
               inputs: Optional[Dict[str, Any]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer step on :func:`stage2_loss`. Returns the loss and its
    terms at the parameters before the step."""
    opt.zero_grad(set_to_none=True)
    loss, aux = stage2_loss(model, g, adj, lam, generator, inputs)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


class Stage2Backend:
    """One device's train step and eval heads over the whole graph ``g``
    (``inputs`` from :func:`model_inputs`); the sharded backends
    (``parallel/stage2_runtime.py``) subclass it. The trainer calls
    ``train_step(opt, generator)`` → ``(loss, aux)``, one optimizer step
    and the loss and its terms before it; ``eval_counts()`` → the eval
    heads' :data:`TABLES` [5, 3, C+1] int64, left on the device for a
    CUDA graph to capture; ``evaluate()`` → ``(scores, per_head)`` on the
    host (source head on train, target-hat on val and test, each head on
    test); ``info()`` → the result's ``parallel``, None here."""

    def __init__(self, model: torch.nn.Module, g: Graph,
                 adj: Optional[Adjacency], inputs: Dict[str, Any],
                 cfg: Stage2Config, num_classes: int):
        self.model, self.g, self.adj, self.inputs = model, g, adj, inputs
        self.cfg, self.num_classes = cfg, num_classes
        splits = [g.train_mask, g.val_mask, g.test_mask]
        # each table's split mask, int32 [5, N]; each row's class, with
        # y == -1 in bin C
        self.table_masks = torch.stack(splits).int()[[m for _, m in TABLES]]
        self.y_bin = torch.where(g.y < 0, num_classes, g.y).long()
        self.y_np = g.y.cpu().numpy()
        self.masks_np = {k: m.cpu().numpy()
                         for k, m in zip(("train", "val", "test"), splits)}

    def heads(self, generator: Optional[torch.Generator] = None):
        """The source, target and target-hat log-probabilities of one
        forward, dropout from ``generator``; a single head stands for all."""
        out = self.model(self.g, self.adj, generator, **self.inputs)
        return out[:3] if isinstance(out, tuple) else (out,) * 3

    def eval_heads(self):
        """:meth:`heads` of the eval-mode forward, without gradients."""
        self.model.eval()
        with torch.no_grad():
            return self.heads()

    def train_step(self, opt: torch.optim.Optimizer,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return train_step(self.model, self.g, self.adj, opt, self.cfg.Lambda,
                          generator, self.inputs)

    def eval_counts(self) -> torch.Tensor:
        heads = self.eval_heads()
        preds = torch.stack([heads[h].argmax(1) for h, _ in TABLES])
        return confusion_counts(preds, self.table_masks, self.y_bin,
                                self.num_classes + 1)

    def _eval_arrays(self, need_probs: bool):
        """The eval heads' predictions [3, N] on the host, and their
        positive-class probabilities when ``need_probs`` (for auc)."""
        heads = self.eval_heads()
        preds = torch.stack([lp.argmax(1) for lp in heads]).cpu().numpy()
        probs = (torch.stack([lp[:, 1].exp() for lp in heads]).cpu().numpy()
                 if need_probs else None)
        return preds, probs

    def evaluate(self):
        preds, probs = self._eval_arrays(self.cfg.metric == "auc")
        return score_arrays(preds, probs, self.y_np, self.masks_np,
                            self.cfg.metric, self.cfg.f1_average)

    def info(self) -> Optional[Dict[str, Any]]:
        return None


# ---------------------------------------------------------------- scan mode


@dataclasses.dataclass
class _ScanRun:
    """What :func:`_epoch_body` reads and writes. Every tensor keeps its
    storage for the whole run, as a CUDA graph's replays need."""

    backend: Stage2Backend
    opt: torch.optim.Optimizer
    gen: torch.Generator
    lr: torch.Tensor       # f64 [], Adam's rate for the next epoch
    schedule: bool         # StepLR on
    step_size: int
    gamma: float
    step: torch.Tensor     # int64 [], epochs done
    i: torch.Tensor        # int64 [1]: the record row this epoch writes
    record: torch.Tensor   # f64 [rows, 2 + 15·bins]: loss, loss_t2, counts


def _scan_run(backend: Stage2Backend, opt, gen, cfg: Stage2Config,
              lr: torch.Tensor, epochs_done: int) -> _ScanRun:
    dev = lr.device
    return _ScanRun(
        backend=backend, opt=opt, gen=gen,
        lr=lr, schedule=cfg.use_scheduler, step_size=cfg.step_size,
        gamma=cfg.gamma,
        step=torch.tensor(epochs_done, dtype=torch.int64, device=dev),
        i=torch.zeros(1, dtype=torch.int64, device=dev),
        record=torch.zeros(
            cfg.scan_epochs, 2 + len(TABLES) * 3 * (backend.num_classes + 1),
            dtype=torch.float64, device=dev))


def _epoch_body(run: _ScanRun) -> None:
    """One epoch of scan mode, on tensors only (JAX ``stage2.py:682-716``;
    sharded, ``parallel/stage2_runtime.py``'s ``scan_chunk``): the
    backend's train step (dropout from the run's generator), Adam,
    StepLR's step computed on the device, and the backend's five
    confusion tables of the eval forward; the losses and the tables go to
    row ``i`` of the record, and ``i`` advances. Nothing in it waits for
    the device, so a CUDA graph can capture it."""
    loss, aux = run.backend.train_step(run.opt, run.gen)
    run.step += 1
    if run.schedule:
        # StepLR's own chained product, so the rate is the float the
        # per-epoch loop's scheduler holds, bit for bit
        run.lr.copy_(torch.where(run.step % run.step_size == 0,
                                 run.lr * run.gamma, run.lr))
    counts = run.backend.eval_counts()
    row = torch.cat([torch.stack([loss, aux["loss_t2"]]).double(),
                     counts.reshape(-1).double()])
    run.record.index_copy_(0, run.i, row[None])
    run.i += 1


def _use_scan(cfg: Stage2Config) -> bool:
    """The JAX rule (``stage2.py:890-895``): scan needs counts-based
    scores and no per-epoch best-weights copy."""
    return (cfg.scan_epochs > 0
            and counts_can_score(cfg.metric, cfg.f1_average)
            and cfg.save_best_path is None)


# -------------------------------------------------------------- the trainer


def train_ktgnn(
    data: Dict[str, np.ndarray],
    cfg: Optional[Stage2Config] = None,
    device="cuda",
    group=None,
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
    there), runs under ``matmul_precision(cfg.matmul_precision)``. A
    sharded scan run's ``scan["capture"]`` names its rule: ``"nccl"`` (the
    epoch captured once, then replayed) or ``"none (gloo)"``.

    ``group``: a process group this rank is in, of ``cfg.n_shards``
    ranks, to train the sharded backends over in place of the default
    group; with it a group of one rank (``n_shards=1``) runs them too.

    Under ``torch.profiler`` (the CLI's ``--profile_dir``) the run is one
    range, ``stage2.train``, holding the graph's build (``stage2.graph``),
    its layouts (``stage2.layout``, its count ``native_sender_csr`` the
    layouts whose sender index the native library built) and in scan
    mode the capture
    (``stage2.capture``) and each chunk's host scoring
    (``stage2.score``); see ``utils/profiling.annotate``."""
    cfg = cfg or Stage2Config()
    check_ported(cfg)
    if group is not None:
        _check_sharded_model(cfg)
    elif cfg.n_shards > 1:
        from bridged_gnn_tpu_torch.parallel import multihost

        if not multihost.init_distributed(torch.device(device).type):
            # not in a process group: start one rank per shard here
            return multihost.spawn(train_ktgnn, cfg.n_shards,
                                   (data, cfg, device),
                                   torch.device(device).type)[0]
    with annotate("stage2.train"), matmul_precision(cfg.matmul_precision):
        return _train_ktgnn(data, cfg, device, group)


def _train_ktgnn(data: Dict[str, np.ndarray], cfg: Stage2Config,
                 device, group=None) -> Dict[str, Any]:
    sharded = cfg.n_shards > 1 or group is not None
    if sharded:
        from bridged_gnn_tpu_torch.parallel.mesh import make_group
        from bridged_gnn_tpu_torch.parallel.multihost import (
            capture_rule,
            describe,
            describe_capture,
            is_primary,
        )
        from bridged_gnn_tpu_torch.parallel.stage2_runtime import (
            make_stage2_backend,
        )

        group, dev = make_group(cfg.n_shards, device, group)
        primary = is_primary()
        g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
    else:
        dev, primary = resolve_device(device), True
        g, adj = prepare_stage2_graph(data, cfg, dev)
    log_every = cfg.log_every if primary else 0
    inputs = model_inputs(data, cfg, g)
    num_classes = g.num_classes
    mem_mode = resolve_memory_policy(cfg)
    if mem_mode != "plain" and log_every:
        print(f"[memory_policy] {mem_mode} engaged (the embedding convs "
              "recompute in the backward)")
    model = build_model(cfg, num_classes, g.num_features, dev,
                        remat=mem_mode == "lean")
    use_scan = _use_scan(cfg)
    # scan mode's capture rule, fixed before the run: on a card one CUDA
    # graph of an epoch; a sharded run's only under NCCL, since gloo's
    # collectives on CUDA tensors go through the host
    if sharded:
        backend = make_stage2_backend(group, dev, model, g, cfg,
                                      num_classes)
        capture, rule = capture_rule(group, dev)
        if log_every:
            print(describe(group, dev))
            print(f"[parallel] {backend.info()}")
            if use_scan:
                print(describe_capture(group, dev))
    else:
        backend = Stage2Backend(model, g, adj, inputs, cfg, num_classes)
        capture, rule = dev.type == "cuda", None
    # the loop's rate is a float that StepLR steps; scan mode's a tensor
    # that the epoch body sets on the device (capturable Adam on a card)
    lr = (torch.tensor(cfg.lr, dtype=torch.float64, device=dev)
          if use_scan else cfg.lr)
    opt, sched = make_optimizer(
        model.parameters(), lr, cfg.weight_decay,
        cfg.use_scheduler and not use_scan, cfg.step_size, cfg.gamma)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

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
        if log_every and epoch % log_every == 0:
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
            if cfg.save_best_path and primary:
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
        # rate in the optimizer's and the epoch. A sharded run's state is
        # the same on every rank (the generator too: every rank draws
        # every row's dropout mask), and rank 0 writes it
        if not primary:
            return
        ckptr.save(epoch, dict(
            model=model.state_dict(), optimizer=opt.state_dict(),
            generator=gen.get_state(), best=best, epoch=epoch,
        ))

    t_start = time.time()
    timer = EpochTimer(dev)
    scan_info = None
    if use_scan:
        # chunks of k = min(scan_epochs, remaining) epochs (JAX
        # stage2.py:896-968), each copying its [k] rows of losses and
        # counts to the host in one copy (numerics checked there); the host
        # scores them, records the epochs and checkpoints
        run = _scan_run(backend, opt, gen, cfg, lr, start_epoch - 1)

        def fetch(first, last):
            rec = run.record[: last - first + 1].cpu().numpy()
            check_numerics(rec[:, :2], last)
            return rec

        def after(first, last, rec):
            k = last - first + 1
            counts = rec[:, 2:].reshape(k, len(TABLES), 3, num_classes + 1)
            for j in range(k):
                record(first + j, float(rec[j, 0]), float(rec[j, 1]),
                       *table_scores(counts[j], cfg.metric, cfg.f1_average))
            if ckptr is not None:
                save(last)

        segments = [(e, min(e + cfg.scan_epochs, cfg.num_epoch + 1) - 1)
                    for e in range(start_epoch, cfg.num_epoch + 1,
                                   cfg.scan_epochs)]
        scan_info = run_scan(segments, lambda: _epoch_body(run), (gen,),
                             run.i, timer, fetch, after, capture=capture,
                             spans="stage2")
        if rule is not None:
            scan_info["capture"] = rule
    else:
        for epoch in range(start_epoch, cfg.num_epoch + 1):
            with timer:
                loss, aux = backend.train_step(opt, gen)
                if sched is not None:
                    sched.step()
                loss, loss_t2 = float(loss), float(aux["loss_t2"])
                check_numerics(np.asarray(loss), epoch)
                scores, per_head = backend.evaluate()
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
        parallel=backend.info(),
    )
