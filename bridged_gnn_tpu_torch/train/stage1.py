"""Stage-1 training runtime: adversarial similarity learning (port of
``bridged_gnn_tpu/train/stage1.py`` on one device; reference
scripts.py:28-94, 430-555).

  * Per epoch: class-balanced pairs sampled on the host (numpy, one
    generator for the whole run), one similarity/autoencoder step, then
    one discriminator step on the step's detached embeddings.
  * Three torch Adams, as the JAX package's two ``optax.multi_transform``
    groups give them: ``source`` (lr 1e-2, L2 weight decay 5e-3),
    ``target`` (lr 1e-3, betas (0.5, 0.999)) for the similarity step and
    ``disc`` (lr 1e-3, betas (0.5, 0.999)) for the discriminator step.
    The similarity loss's generator term also leaves gradients on the
    discriminator; JAX's frozen group drops them, and so does the port,
    which clears them before the discriminator's own backward.
  * Loss: three pair BCEs + (generator BCE + 0.1·reconstruction MSE)
    [+ the two classifiers' NLL]; the discriminator's BCE with real =
    source and fake = target, averaged.
  * Evaluation: balanced samples of 100k pairs (or every pair) per
    relation and split; the model is kept by the cross-domain pair F1 on
    val.

Scan mode (``scan_epochs > 0``, JAX ``stage1.py:283-371, 1038-1129``)
runs the epochs in segments that end on evaluation epochs
(:func:`segment_bounds`). A segment's host-sampled pairs go to the
device in one copy, into static ``[scan_epochs, ...]`` buffers that each
epoch reads at its row; ``device_sampling`` draws them on the device
instead (``train/device_sampler.py``), the targets from the labels
there, so a segment copies nothing from the host. On the card the first
epochs run eagerly, one epoch (similarity step, discriminator step, the
three Adams, capturable) is then captured in a CUDA graph and replayed,
one graph for every segment length; on the CPU every epoch runs eagerly,
so CPU scan equals the CPU loop. Each segment makes one copy to the host
(its losses, the last epoch's pair predictions and targets), evaluates,
checks numerics and checkpoints at its end. With ``device_sampling`` the
evaluation is :class:`DeviceStage1Evaluator` where JAX engages its own:
one encode per domain, balanced pairs drawn on the device, confusion
counts copied once.

With the ``gnn`` backbone every SAGE aggregation is the padded SpMM
kernel (``csrc/gather_reduce.cu``): per training step two forwards per
domain and, in the backward, the transposed SpMM for every conv input
that needs a gradient (not the source's raw features), so three.

Row sharding (``n_shards > 1``, JAX ``stage1.py:827-868``) trains over
that many ranks of a process group, one per shard; outside a group
:func:`train_adversarial` starts the ranks itself
(``parallel.multihost.spawn``) and returns rank 0's result. Both domain
graphs are repadded to a multiple of ``n·NODE_BLOCK`` rows and each rank
encodes its block of rows (``parallel/gspmd.py``): a SAGE conv's input
rows are all-gathered and its aggregation runs ``gather_reduce`` on the
slot layout of the rank's destination rows over every sender, PairNorm
takes global moments, and the final embeddings are all-gathered. Every
rank then computes the whole loss (the pair BCEs, the autoencoder's
terms, the classifiers' NLL) from the same host-sampled pairs and
backpropagates ``1/n`` of it; the gathers' backward sums the cotangents
over the ranks, and one all-reduce sums the parameters' gradients, so
each gradient is counted once and every rank takes the single device's
step. The discriminator's step runs alike on every rank from the
gathered embeddings. Dropout masks are the single device's bit for bit;
the host evaluator runs on every rank from sharded encodes; rank 0 prints
and writes the checkpoints, which every rank reads on ``resume``. Device
sampling with ``n_shards > 1`` raises JAX's ``ValueError``. Scan mode
with host pairs captures its epoch under NCCL and runs every epoch
eagerly under gloo, by stage 2's rule.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import Graph, graph_from_dict
from bridged_gnn_tpu_torch.nn.common import masked_nll
from bridged_gnn_tpu_torch.nn.stage1 import AdversarialLearnerV2
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, adjacency_from_graph
from bridged_gnn_tpu_torch.parallel.collectives import GradAllReduce
from bridged_gnn_tpu_torch.train.device_sampler import (
    DeviceBalancedSampler,
    build_device_samplers,
    pair_targets,
    sample_epoch_on_device,
)
from bridged_gnn_tpu_torch.train.metrics import (
    confusion_counts,
    eval_metric,
    score_from_counts,
)
from bridged_gnn_tpu_torch.train.optim import load_optimizer_state
from bridged_gnn_tpu_torch.train.samplers import (
    PairEnumerator,
    PairEnumeratorCross,
    enumerate_all_pairs,
)
from bridged_gnn_tpu_torch.train.scan import run_scan
from bridged_gnn_tpu_torch.utils.platform import resolve_device
from bridged_gnn_tpu_torch.utils.profiling import EpochTimer, annotate
from bridged_gnn_tpu_torch.utils.sanitizers import assert_all_finite

_EPS = 1e-7  # probability clamp of the BCEs
EVAL_CHUNK = 131072  # pairs scored per call in evaluation


@dataclasses.dataclass
class Stage1Config:
    hidden_dim: int = 64
    num_layer: int = 2
    num_epoch: int = 400
    start_eval_epoch: int = 300
    eval_per_epoch: int = 1
    max_class_num: int = 10
    sample_size: int = 40000
    sim_mode: str = "mlp"
    backbone: str = "mlp"
    norm_mode: str = "None"
    norm_scale: float = 1.0
    use_clf: bool = True
    use_norm: bool = True
    eval_mode: str = "sampling"  # 'sampling' | 'all'
    eval_sample_size: int = 100000
    seed: int = 0
    repeat: int = 1
    metric: str = "f1"
    verbose: bool = False
    ckpt_dir: Optional[str] = None   # periodic checkpoints + resume
    ckpt_every: int = 100
    resume: bool = False
    # quantile filter restricting pair eval to high-confidence predictions
    # (reference conf_lower_bound, scripts.py:350-358); None = all pairs
    conf_lower_bound: Optional[float] = None
    # raise FloatingPointError on a non-finite similarity loss or
    # parameter: every epoch, in scan mode at every segment's end
    check_numerics: bool = False
    # >0: up to this many epochs per segment, one host round trip each;
    # segments end on evaluation epochs
    scan_epochs: int = 0
    # draw the training pairs on the device (train/device_sampler.py):
    # the host sampler's distributions, not its streams; needs
    # scan_epochs > 0
    device_sampling: bool = False
    # >1: both domain graphs row-sharded over that many ranks
    # (parallel/gspmd.py); host pair sampling
    n_shards: int = 1


def check_ported(cfg: Stage1Config, sharded: bool = False) -> None:
    """Raise JAX's ``ValueError`` for device sampling without scan mode
    (the sampler lives inside the scanned epoch) or with row sharding
    (``n_shards > 1``, or ``sharded``: a caller's group), and for
    ``n_shards < 1``."""
    if cfg.n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {cfg.n_shards}")
    if cfg.device_sampling and cfg.scan_epochs <= 0:
        raise ValueError(
            "device_sampling requires scan_epochs > 0 (the device sampler "
            "lives inside the scanned epoch body)")
    if cfg.device_sampling and (cfg.n_shards > 1 or sharded):
        raise ValueError(
            "n_shards > 1 uses the host sampling path; device_sampling "
            "has its own DP pair sharding (train/device_sampler.py)")


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    p = probs.clamp(_EPS, 1 - _EPS)
    return -(targets * torch.log(p)
             + (1 - targets) * torch.log(1 - p)).mean()


def build_model(cfg: Stage1Config, src: Dict, tar: Dict, device="cuda",
                seed: Optional[int] = None) -> AdversarialLearnerV2:
    """The stage-1 model of ``cfg`` for the two domains, its init drawn
    from ``seed`` (default ``cfg.seed``), on ``device``."""
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = AdversarialLearnerV2(
        dim_in_src=src["x"].shape[1],
        dim_in_tar=tar["x"].shape[1],
        num_classes_src=int(np.asarray(src["y"]).max()) + 1,
        num_classes_tar=int(np.asarray(tar["y"]).max()) + 1,
        dim_hidden=cfg.hidden_dim,
        source_clf=cfg.use_clf,
        use_norm=cfg.use_norm,
        norm_mode=cfg.norm_mode,
        norm_scale=cfg.norm_scale,
        backbone=cfg.backbone,
        sim_mode=cfg.sim_mode,
        num_layer=cfg.num_layer,
        generator=gen,
    )
    return model.to(resolve_device(device))


def make_optimizers(model: AdversarialLearnerV2, capturable: bool = False
                    ) -> Dict[str, torch.optim.Adam]:
    """The three Adams of the reference (scripts.py:464-469; JAX
    ``_group_optimizers``): ``source`` and ``target`` step together in the
    similarity step, ``disc`` in the discriminator step. ``capturable``:
    their step counts on the device, as a CUDA graph's replays need."""
    return dict(
        source=torch.optim.Adam(model.source_learner.parameters(), lr=1e-2,
                                weight_decay=5e-3, capturable=capturable),
        target=torch.optim.Adam(model.target_learner.parameters(), lr=1e-3,
                                betas=(0.5, 0.999), capturable=capturable),
        disc=torch.optim.Adam(model.discriminator.parameters(), lr=1e-3,
                              betas=(0.5, 0.999), capturable=capturable),
    )


@dataclasses.dataclass(frozen=True)
class Stage1Graphs:
    """Both domains on one device: features, node masks, labels and
    train masks (padded rows), and the adjacencies (None for the ``mlp``
    backbone). A row-sharded run (``n_shards > 1``) has no adjacencies
    here but this rank's shard of each domain (``parallel/gspmd.py``),
    which its encoders run on, and ``grad_sync``, the sum of the
    similarity step's gradients over the ranks."""

    g_src: Graph
    g_tar: Graph
    adj_src: Optional[Adjacency]
    adj_tar: Optional[Adjacency]
    shard_src: Any = None
    shard_tar: Any = None
    grad_sync: Optional[GradAllReduce] = None

    def encoder_inputs(self):
        """``(x_src, adj_src, x_tar, adj_tar)`` the encoders take: the
        whole graphs', or this rank's rows and the edges into them."""
        if self.shard_src is None:
            return self.g_src.x, self.adj_src, self.g_tar.x, self.adj_tar
        return (self.shard_src.x, self.shard_src.adj, self.shard_tar.x,
                self.shard_tar.adj)


def prepare_stage1_graphs(src_d: Dict, tar_d: Dict, backbone: str,
                          device="cuda") -> Stage1Graphs:
    """Padded graphs of both domains on ``device`` and, for the ``gnn``
    backbone, their adjacencies (``"auto"``: the slot layouts of the
    padded SpMM kernel)."""
    dev = resolve_device(device)
    g_src = graph_from_dict(src_d).to(dev)
    g_tar = graph_from_dict(tar_d).to(dev)
    gnn = backbone == "gnn"
    return Stage1Graphs(
        g_src=g_src, g_tar=g_tar,
        adj_src=adjacency_from_graph(g_src, "auto", device=dev)
        if gnn else None,
        adj_tar=adjacency_from_graph(g_tar, "auto", device=dev)
        if gnn else None)


def prepare_sharded_stage1_graphs(src_d: Dict, tar_d: Dict, backbone: str,
                                  group, device) -> Stage1Graphs:
    """Both domains for one rank of a row-sharded run: the whole graphs
    on ``device`` (their labels and masks enter the loss) and this rank's
    :class:`~bridged_gnn_tpu_torch.parallel.gspmd.RowShard` of each."""
    from bridged_gnn_tpu_torch.parallel.gspmd import shard_stage1_graph

    dev = resolve_device(device)
    g_src = graph_from_dict(src_d).to(dev)
    g_tar = graph_from_dict(tar_d).to(dev)
    _, shard_src = shard_stage1_graph(group, g_src, backbone, dev)
    _, shard_tar = shard_stage1_graph(group, g_tar, backbone, dev)
    return Stage1Graphs(g_src=g_src, g_tar=g_tar, adj_src=None,
                        adj_tar=None, shard_src=shard_src,
                        shard_tar=shard_tar)


def encode_graphs(model: AdversarialLearnerV2, G: Stage1Graphs
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both domains' eval-mode embeddings (whole tables, sharded or
    not)."""
    x_src, adj_src, x_tar, adj_tar = G.encoder_inputs()
    model.eval()
    with torch.no_grad():
        return model.encode_domains(
            x_src, adj_src, x_tar, adj_tar, G.g_src.node_mask,
            G.g_tar.node_mask, shard_src=G.shard_src, shard_tar=G.shard_tar)


def sim_loss(model: AdversarialLearnerV2, G: Stage1Graphs,
             idxs: Dict[str, torch.Tensor], y_pairs: Dict[str, torch.Tensor],
             use_clf: bool, generator: Optional[torch.Generator]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The similarity/autoencoder loss of one train-mode forward (JAX
    ``sim_loss``; reference scripts.py:37-63) and its parts; ``h_src`` and
    ``h_tar`` detached for the discriminator step."""
    gs, gt = G.g_src, G.g_tar
    x_src, adj_src, x_tar, adj_tar = G.encoder_inputs()
    model.train()
    out = model.train_forward(
        x_src, adj_src, x_tar, adj_tar, idxs["src1"], idxs["src2"],
        idxs["tar1"], idxs["tar2"], idxs["cross1"], idxs["cross2"],
        mask_src=gs.node_mask, mask_tar=gt.node_mask, generator=generator,
        shard_src=G.shard_src, shard_tar=G.shard_tar)
    loss_src = bce(out["probs_pair_src"][:, 0], y_pairs["src"])
    loss_tar = bce(out["probs_pair_tar"][:, 0], y_pairs["tar"])
    loss_cross = bce(out["probs_pair_cross"][:, 0], y_pairs["cross"])
    # AE: reconstruction MSE over real rows + generator BCE (:50-55)
    nmt = gt.node_mask.to(out["recons"].dtype)
    n_real = nmt.sum().clamp(min=1)
    loss_recons = (((out["recons"] - out["h0_tar"]) ** 2) * nmt[:, None]
                   ).sum() / (n_real * out["recons"].shape[1])
    d_probs = out["d_tar"][:, 0].clamp(_EPS, 1 - _EPS)
    loss_g = -(torch.log(d_probs) * nmt).sum() / n_real
    loss_ae = loss_g + loss_recons * 0.1
    loss = loss_src + loss_tar + loss_cross + loss_ae
    if use_clf:
        loss = loss + masked_nll(out["log_clf_src"], gs.y, gs.train_mask)
        loss = loss + masked_nll(out["log_clf_tar"], gt.y, gt.train_mask)
    aux = dict(
        loss_ae=loss_ae, loss_g=loss_g, loss_recons=loss_recons,
        probs_src=out["probs_pair_src"][:, 0],
        probs_tar=out["probs_pair_tar"][:, 0],
        probs_cross=out["probs_pair_cross"][:, 0],
        h_src=out["h_src"].detach(), h_tar=out["h_tar"].detach(),
    )
    return loss, aux


def _step(opts, params) -> None:
    """Step ``opts`` with a zero gradient where a parameter got none, as
    the JAX package's optax groups update every parameter of theirs."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for opt in opts:
        opt.step()


def sim_step(model, opts, G, idxs, y_pairs, use_clf, generator
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of the source and target Adams on :func:`sim_loss`;
    returns the loss and its parts at the parameters before the step. The
    discriminator is not stepped; its gradients from ``loss_g`` stay
    until :func:`d_step` clears them. A row-sharded rank backpropagates
    ``1/n`` of the whole loss, and ``G.grad_sync`` sums the learners'
    gradients over the ranks."""
    for opt in opts.values():
        opt.zero_grad(set_to_none=True)
    loss, aux = sim_loss(model, G, idxs, y_pairs, use_clf, generator)
    if G.grad_sync is None:
        loss.backward()
    else:
        (loss / G.grad_sync.n).backward()
        G.grad_sync()
    _step((opts["source"], opts["target"]),
          list(model.source_learner.parameters())
          + list(model.target_learner.parameters()))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def d_loss(model, h_src, h_tar, nm_src, nm_tar) -> torch.Tensor:
    """The discriminator's BCE (scripts.py:84-92): real = the source's
    rows, fake = the target's, each the mean over real rows."""
    p_real = model.discriminate(h_src)[:, 0]
    p_fake = model.discriminate(h_tar)[:, 0]
    m_src = nm_src.to(p_real.dtype)
    m_tar = nm_tar.to(p_fake.dtype)
    real = -(torch.log(p_real.clamp(_EPS, 1 - _EPS)) * m_src).sum() \
        / m_src.sum().clamp(min=1)
    fake = -(torch.log((1 - p_fake).clamp(_EPS, 1 - _EPS)) * m_tar).sum() \
        / m_tar.sum().clamp(min=1)
    return (real + fake) / 2


def d_step(model, opts, G, h_src, h_tar) -> torch.Tensor:
    """One step of the discriminator's Adam on :func:`d_loss`, from the
    similarity step's detached embeddings (JAX ``d_step``)."""
    opts["disc"].zero_grad(set_to_none=True)
    loss = d_loss(model, h_src, h_tar, G.g_src.node_mask,
                  G.g_tar.node_mask)
    loss.backward()
    _step((opts["disc"],), list(model.discriminator.parameters()))
    return loss.detach()


def _confidence_mask(probs: np.ndarray, conf_lower_bound) -> np.ndarray:
    """Restrict evaluation to high-confidence pair predictions (reference
    ``conf_lower_bound`` quantile filter, scripts.py:350-358): keep pairs
    whose probability lies in the extreme quantiles."""
    if conf_lower_bound is None:
        return np.ones(len(probs), dtype=bool)
    assert 0.0 <= conf_lower_bound <= 1.0
    high = np.quantile(probs, conf_lower_bound)
    low = np.quantile(probs, 1 - conf_lower_bound)
    return (probs >= high) | (probs <= low)


def _pair_scores_in_chunks(score_fn, idx1: np.ndarray, idx2: np.ndarray,
                           device, chunk: int = EVAL_CHUNK) -> np.ndarray:
    """A pair-scoring closure over host index arrays, ``chunk`` pairs a
    call."""
    out = np.empty(len(idx1), dtype=np.float32)
    for s in range(0, len(idx1), chunk):
        e = min(s + chunk, len(idx1))
        i1 = torch.from_numpy(np.asarray(idx1[s:e], np.int64)).to(device)
        i2 = torch.from_numpy(np.asarray(idx2[s:e], np.int64)).to(device)
        out[s:e] = score_fn(i1, i2).cpu().numpy()
    return out


class Stage1Evaluator:
    """Pair prediction and node classification on val or test
    (scripts.py:315-426; JAX ``Stage1Evaluator``), of the weights the
    model holds when called.

    The JAX evaluator re-encodes both graphs for every chunk of pairs it
    scores. Eval mode is deterministic, so this one encodes both domains
    once per call and scores every chunk from those embeddings: the
    numbers are the same (``tests/test_torch_stage1.py`` holds it)."""

    def __init__(self, model: AdversarialLearnerV2, G: Stage1Graphs,
                 src_d: Dict, tar_d: Dict, cfg: Stage1Config,
                 rng: np.random.Generator, chunk: int = EVAL_CHUNK):
        self.model = model
        self.G = G
        self.src_d, self.tar_d = src_d, tar_d
        self.cfg = cfg
        self.chunk = chunk
        self.scored = 0   # pairs scored so far
        self.enus = {
            split: (PairEnumerator(src_d, split, rng),
                    PairEnumerator(tar_d, split, rng),
                    PairEnumeratorCross(src_d, tar_d, split, rng))
            for split in ("val", "test")
        }

    def _scores(self, fn, idx1, idx2) -> np.ndarray:
        self.scored += len(idx1)
        return _pair_scores_in_chunks(fn, idx1, idx2, self.G.g_src.x.device,
                                      self.chunk)

    def _metric(self, y_pair, probs) -> float:
        keep = _confidence_mask(probs, self.cfg.conf_lower_bound)
        return eval_metric(y_pair[keep], (probs[keep] > 0.5).astype(int),
                           self.cfg.metric, "binary", probs[keep])

    def _within(self, data, fn, enu, split) -> float:
        cfg = self.cfg
        if cfg.eval_mode == "sampling":
            idx1, idx2 = enu.balanced_sampling(
                max_class_num=enu.num_classes,
                sample_size=cfg.eval_sample_size, shuffle=False)
        else:
            mask1 = (np.asarray(data["train_mask"])
                     | np.asarray(data["val_mask"])
                     | np.asarray(data["test_mask"]))
            mask2 = np.asarray(
                data["val_mask" if split == "val" else "test_mask"])
            idx1, idx2 = enumerate_all_pairs(np.where(mask1)[0],
                                             np.where(mask2)[0])
        y = np.asarray(data["y"])
        y_pair = (y[idx1] == y[idx2]).astype(int)
        return self._metric(y_pair, self._scores(fn, idx1, idx2))

    def _cross(self, fn, split) -> float:
        cfg = self.cfg
        enu = self.enus[split][2]
        if cfg.eval_mode == "sampling":
            idx1, idx2 = enu.balanced_sampling(
                max_class_num=enu.num_classes,
                sample_size=cfg.eval_sample_size, shuffle=False)
        else:
            # reference eval_cross_domain_v2 'all' (scripts.py:316-332)
            sd, td = self.src_d, self.tar_d

            def m(d, *names):
                return np.logical_or.reduce(
                    [np.asarray(d[f"{n}_mask"]) for n in names])

            if split == "val":
                pairs = ((m(sd, "val"), m(td, "train", "val")),
                         (m(sd, "train"), m(td, "val")))
            else:
                pairs = ((m(sd, "test"), m(td, "train", "test", "val")),
                         (m(sd, "train", "val"), m(td, "test")))
            both = [enumerate_all_pairs(np.where(a)[0], np.where(b)[0])
                    for a, b in pairs]
            idx1 = np.concatenate([both[0][0], both[1][0]])
            idx2 = np.concatenate([both[0][1], both[1][1]])
        y_pair = (np.asarray(self.src_d["y"])[idx1]
                  == np.asarray(self.tar_d["y"])[idx2]).astype(int)
        return self._metric(y_pair, self._scores(fn, idx1, idx2))

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both domains' eval-mode embeddings."""
        return encode_graphs(self.model, self.G)

    def __call__(self, split: str, epoch: int = 0):
        """(src pair score, src clf score, tar pair score, tar clf score,
        cross pair score) on ``split``. ``epoch`` keeps JAX's signature;
        the host sampler advances its own generator."""
        z_src, z_tar = self.encode()
        sim = self.model.source_learner.sim_net
        enu_src, enu_tar, _ = self.enus[split]
        with torch.no_grad():
            pair_src = self._within(
                self.src_d, lambda a, b: sim.similarity(z_src, a, b),
                enu_src, split)
            pair_tar = self._within(
                self.tar_d, lambda a, b: sim.similarity(z_tar, a, b),
                enu_tar, split)
            pair_cross = self._cross(
                lambda a, b: sim.similarity_cross_domain(z_src, z_tar, a, b),
                split)
            clf = {}
            for name, data, z in (("src", self.src_d, z_src),
                                  ("tar", self.tar_d, z_tar)):
                mask = np.asarray(
                    data["val_mask" if split == "val" else "test_mask"])
                pred = sim.classify(z).argmax(1).cpu().numpy()
                clf[name] = eval_metric(np.asarray(data["y"])[mask],
                                        pred[: len(mask)][mask],
                                        self.cfg.metric, "macro")
        return pair_src, clf["src"], pair_tar, clf["tar"], pair_cross


def _seed_of(*parts: int) -> int:
    """A 64-bit generator seed that depends on every one of ``parts``."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0])


RELATIONS = ("src", "tar", "cross")
_SPLITS = ("val", "test")


class DeviceStage1Evaluator:
    """The evaluation of device sampling (JAX ``DeviceStage1Evaluator``,
    ``stage1.py:576-808``), for ``eval_mode="sampling"`` and the metrics
    that counts give (f1, acc; no ``conf_lower_bound``): balanced val and
    test pairs drawn on the device (:class:`DeviceBalancedSampler`, each
    domain's class count as ``max_class_num``, as the host evaluator
    passes it), scored from one encode per domain, and every confusion
    count formed there, without atomics or a sync
    (``train/metrics.py::confusion_counts``): ``[3, 2]`` per pair relation, ``[3, C+1]`` per
    classifier, bin C holding ``y == -1``. One copy to the host; the
    scores are ``score_from_counts``', the same floats ``eval_metric``
    gives on the same rows.

    A split's pairs at an epoch come from a generator seeded from
    ``(seed + 0x5EED, split, epoch)``, so :meth:`both` equals the two
    per-split calls bit for bit. Distribution-equal to the host
    evaluator's numpy stream, not stream-equal."""

    def __init__(self, model: AdversarialLearnerV2, G: "Stage1Graphs",
                 src_d: Dict, tar_d: Dict, cfg: Stage1Config,
                 seed: Optional[int] = None):
        self.model, self.G, self.cfg = model, G, cfg
        self.seed = (cfg.seed or 0) if seed is None else seed
        self.scored = 0   # pairs scored so far
        dev = G.g_src.x.device
        n_src = int(np.asarray(src_d["y"]).max()) + 1
        n_tar = int(np.asarray(tar_d["y"]).max()) + 1
        size = cfg.eval_sample_size
        self.samplers = {split: (
            DeviceBalancedSampler(src_d, n_src, size, split, device=dev),
            DeviceBalancedSampler(tar_d, n_tar, size, split, device=dev),
            DeviceBalancedSampler(src_d, n_src, size, split, data2=tar_d,
                                  device=dev),
        ) for split in _SPLITS}
        self.labels = {"src": G.g_src.y.long(), "tar": G.g_tar.y.long()}
        self.bins = (n_src + 1, n_tar + 1)
        self.y_bin = tuple(torch.where(y < 0, n, y) for y, n in zip(
            self.labels.values(), (n_src, n_tar)))
        self.masks = {split: tuple(getattr(g, f"{split}_mask").int()[None]
                                   for g in (G.g_src, G.g_tar))
                      for split in _SPLITS}

    def generator(self, split: str, epoch: int) -> torch.Generator:
        gen = torch.Generator(device=self.G.g_src.x.device)
        return gen.manual_seed(_seed_of(self.seed + 0x5EED,
                                        _SPLITS.index(split), epoch))

    def draw(self, split: str, epoch: int) -> Dict[str, Tuple[torch.Tensor,
                                                              torch.Tensor]]:
        """The pairs ``split``'s evaluation at ``epoch`` scores, by
        relation."""
        gen = self.generator(split, epoch)
        return {rel: s.sample(gen)
                for rel, s in zip(RELATIONS, self.samplers[split])}

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return encode_graphs(self.model, self.G)

    def _counts(self, z_src, z_tar, split: str, epoch: int) -> torch.Tensor:
        """Every count of ``split`` at ``epoch``, flat: the three pair
        tables, then the two classifiers'."""
        sim = self.model.source_learner.sim_net
        pairs = self.draw(split, epoch)
        self.scored += sum(len(p[0]) for p in pairs.values())
        probs = dict(src=sim.similarity(z_src, *pairs["src"]),
                     tar=sim.similarity(z_tar, *pairs["tar"]),
                     cross=sim.similarity_cross_domain(z_src, z_tar,
                                                       *pairs["cross"]))
        truth = pair_targets(self.labels, {
            f"{rel}{side}": pairs[rel][side - 1]
            for rel in RELATIONS for side in (1, 2)})
        out = []
        for rel in RELATIONS:
            pred = (probs[rel] > 0.5).long()[None]
            out.append(confusion_counts(
                pred, torch.ones_like(pred, dtype=torch.int32),
                truth[rel].long(), 2))
        for z, y_bin, mask, bins in zip((z_src, z_tar), self.y_bin,
                                        self.masks[split], self.bins):
            out.append(confusion_counts(sim.classify(z).argmax(1)[None],
                                         mask, y_bin, bins))
        return torch.cat([c.reshape(-1) for c in out])

    def _scores(self, flat: np.ndarray) -> Tuple[float, ...]:
        """(src pair, src clf, tar pair, tar clf, cross pair) scores from
        one split's counts. A pair table gets an empty ``y == -1`` bin,
        the layout ``score_from_counts`` reads."""
        b_src, b_tar = self.bins
        pair = [np.pad(t.reshape(3, 2), ((0, 0), (0, 1)))
                for t in np.split(flat[:18], 3)]
        clf_src = flat[18: 18 + 3 * b_src].reshape(3, b_src)
        clf_tar = flat[18 + 3 * b_src:].reshape(3, b_tar)
        metric = self.cfg.metric
        return (score_from_counts(*pair[0], metric=metric,
                                  f1_average="binary"),
                score_from_counts(*clf_src, metric=metric,
                                  f1_average="macro"),
                score_from_counts(*pair[1], metric=metric,
                                  f1_average="binary"),
                score_from_counts(*clf_tar, metric=metric,
                                  f1_average="macro"),
                score_from_counts(*pair[2], metric=metric,
                                  f1_average="binary"))

    def both(self, epoch: int = 0):
        """(val scores, test scores) from one encode per domain and one
        copy to the host; equal to ``self("val", epoch), self("test",
        epoch)``."""
        z_src, z_tar = self.encode()
        with torch.no_grad():
            flat = torch.cat([self._counts(z_src, z_tar, split, epoch)
                              for split in _SPLITS]).cpu().numpy()
        half = len(flat) // 2
        return self._scores(flat[:half]), self._scores(flat[half:])

    def __call__(self, split: str, epoch: int = 0):
        z_src, z_tar = self.encode()
        with torch.no_grad():
            flat = self._counts(z_src, z_tar, split, epoch).cpu().numpy()
        return self._scores(flat)


def use_device_evaluator(cfg: Stage1Config) -> bool:
    """JAX's rule (``stage1.py:912-917``) for the device evaluator."""
    return (cfg.device_sampling and cfg.eval_mode == "sampling"
            and cfg.metric in ("f1", "acc") and cfg.conf_lower_bound is None)


# ---------------------------------------------------------------- scan mode


def segment_bounds(start_epoch: int, cfg: Stage1Config
                   ) -> List[Tuple[int, int]]:
    """Scan mode's segments ``(first, last)`` from ``start_epoch``: up to
    ``scan_epochs`` epochs each, ending on every evaluation epoch (JAX
    ``stage1.py:1043-1052``)."""
    out, epoch = [], start_epoch
    while epoch <= cfg.num_epoch:
        last = min(epoch + cfg.scan_epochs - 1, cfg.num_epoch)
        if last >= cfg.start_eval_epoch:
            nxt = ((epoch - 1) // cfg.eval_per_epoch + 1) * cfg.eval_per_epoch
            nxt = max(nxt, cfg.start_eval_epoch - 1)
            last = min(last, max(nxt, epoch))
        out.append((epoch, last))
        epoch = last + 1
    return out


class _HostPairs:
    """Scan mode's host-sampled pairs: a segment's epochs drawn by
    ``sample`` (the loop's numpy sampler, in its order) and copied in one
    transfer into a static ``[scan_epochs, 2·P]`` buffer; each epoch reads
    its row ``i`` (a device counter), its targets from the labels on the
    device."""

    def __init__(self, sample: Callable[[], Dict[str, np.ndarray]],
                 sizes: Tuple[int, ...], scan_epochs: int,
                 labels: Dict[str, torch.Tensor], i: torch.Tensor):
        self.sample, self.labels, self.i = sample, labels, i
        self.splits = [n for n in sizes for _ in (1, 2)]
        self.buf = torch.zeros(scan_epochs, sum(self.splits),
                               dtype=torch.int64, device=i.device)

    def load(self, k: int) -> None:
        rows = []
        for _ in range(k):
            idxs = self.sample()
            rows.append(np.concatenate([idxs[f"{rel}{side}"]
                                        for rel in RELATIONS
                                        for side in (1, 2)]))
        self.buf[:k].copy_(torch.from_numpy(np.stack(rows)))

    def __call__(self):
        row = self.buf.index_select(0, self.i)[0]
        idxs = dict(zip((f"{rel}{side}" for rel in RELATIONS
                         for side in (1, 2)), row.split(self.splits)))
        return idxs, pair_targets(self.labels, idxs)


@dataclasses.dataclass
class _ScanRun:
    """What :func:`_scan_epoch` reads and writes. Every tensor keeps its
    storage for the whole run, as a CUDA graph's replays need."""

    model: AdversarialLearnerV2
    G: "Stage1Graphs"
    opts: Dict[str, torch.optim.Adam]
    gen: torch.Generator           # dropout
    generators: Tuple[torch.Generator, ...]   # every one the epoch draws
    use_clf: bool
    draw: Callable                 # this epoch's (idxs, y_pairs)
    i: torch.Tensor                # int64 [1]: this epoch's record row
    out: torch.Tensor              # f32, what a segment copies: the two
    record: torch.Tensor           # views [scan_epochs, 3] (sim, d, AE
    last: torch.Tensor             # losses) and [2, P] (the last epoch's
                                   # predictions and targets by relation)


def _scan_epoch(run: _ScanRun) -> None:
    """One epoch of scan mode on tensors alone (JAX ``_epoch``,
    ``stage1.py:283-310``): its pairs, the similarity step and the
    discriminator step; the losses go to row ``i`` of the record, the
    pair predictions and targets to ``last``, and ``i`` advances.
    Nothing in it waits for the device, so a CUDA graph can capture
    it."""
    idxs, y_pairs = run.draw()
    loss_sim, aux = sim_step(run.model, run.opts, run.G, idxs, y_pairs,
                             run.use_clf, run.gen)
    loss_d = d_step(run.model, run.opts, run.G, aux["h_src"], aux["h_tar"])
    run.record.index_copy_(0, run.i, torch.stack(
        [loss_sim, loss_d, aux["loss_ae"]])[None])
    run.last.copy_(torch.stack([
        torch.cat([aux[f"probs_{rel}"] > 0.5 for rel in RELATIONS]).float(),
        torch.cat([y_pairs[rel] for rel in RELATIONS])]))
    run.i += 1


# -------------------------------------------------------------- the trainer


def train_adversarial(
    src_d: Dict[str, np.ndarray],
    tar_d: Dict[str, np.ndarray],
    cfg: Optional[Stage1Config] = None,
    ckpt_path: Optional[str] = None,
    device="cuda",
    group=None,
) -> Dict[str, Any]:
    """A full stage-1 run on ``device`` (reference main_adv_v2,
    scripts.py:430-555). Returns the best scores (``best``), the model
    holding the best weights, those weights as a state dict on the CPU
    (``state_dict``) and in the flax layout (``variables``, what
    ``ckpt_path`` gets), the per-repeat scores and their summary, the
    per-epoch losses (``history``), the epoch timer's summary, the
    evaluations' seconds (``eval_s``), the seconds of the repeats' epochs,
    evaluations and checkpoints (``total_time``: the graphs' and models'
    builds left out) and, in scan mode, ``scan``: the
    last repeat's eager epochs, captures, replays, each replay's kernel
    launches and segments (a row-sharded run's also its ``capture``
    rule, ``"nccl"`` or ``"none (gloo)"``).

    ``n_shards > 1``: called on every rank of a process group of that
    many ranks, or outside one, when it starts the ranks itself and
    returns rank 0's result. ``group``: a process group this rank is in,
    of ``cfg.n_shards`` ranks, to shard the rows over in place of the
    default group; with it a group of one rank (``n_shards=1``) runs the
    sharded path too.

    Under ``torch.profiler`` the run is one range, ``stage1.train``
    (counts ``segments``, scan mode's, and ``evaluations``), holding the
    graphs' preparation (``stage1.graphs``), each repeat's build of the
    model, Adams, samplers and evaluator (``stage1.build``), in scan mode
    the capture (``stage1.capture``) and each segment's host work
    (``stage1.score``), each evaluation (``stage1.eval``, counts
    ``pairs``) and each copy of the best weights to the host
    (``stage1.best``, counts ``bytes``); see
    ``utils/profiling.annotate``."""
    cfg = cfg or Stage1Config()
    check_ported(cfg, sharded=group is not None)
    if cfg.n_shards > 1 and group is None:
        from bridged_gnn_tpu_torch.parallel import multihost

        if not multihost.init_distributed(torch.device(device).type):
            # not in a process group: start one rank per shard here
            return multihost.spawn(
                train_adversarial, cfg.n_shards,
                (src_d, tar_d, cfg, ckpt_path, device),
                torch.device(device).type)[0]
    with annotate("stage1.train") as span:
        out = _train_adversarial(src_d, tar_d, cfg, ckpt_path, device,
                                 group)
        span.counts.update(
            segments=cfg.repeat * len(out["scan"]["segments"])
            if out["scan"] else 0,
            evaluations=len(out["eval_s"]))
    return out


def _train_adversarial(src_d, tar_d, cfg: Stage1Config, ckpt_path,
                       device, group=None) -> Dict[str, Any]:
    from bridged_gnn_tpu_torch.io.flax_weights import (
        flax_variables_from_state_dict,
    )

    sharded = cfg.n_shards > 1 or group is not None
    primary, capture, rule = True, None, None
    if sharded:
        from bridged_gnn_tpu_torch.parallel.mesh import make_group
        from bridged_gnn_tpu_torch.parallel.multihost import (
            capture_rule,
            describe,
            describe_capture,
            is_primary,
        )

        group, dev = make_group(cfg.n_shards, device, group)
        primary = is_primary()
        with annotate("stage1.graphs"):
            G = prepare_sharded_stage1_graphs(src_d, tar_d, cfg.backbone,
                                              group, dev)
        capture, rule = capture_rule(group, dev)
        if cfg.verbose and primary:
            print(describe(group, dev))
            if cfg.scan_epochs > 0:
                print(describe_capture(group, dev))
    else:
        dev = resolve_device(device)
        with annotate("stage1.graphs"):
            G = prepare_stage1_graphs(src_d, tar_d, cfg.backbone, dev)
    verbose = cfg.verbose and primary
    y_src, y_tar = np.asarray(src_d["y"]), np.asarray(tar_d["y"])
    # each relation's labels on its two sides
    pair_labels = (("src", y_src, y_src), ("tar", y_tar, y_tar),
                   ("cross", y_src, y_tar))
    scan = cfg.scan_epochs > 0

    final = {"train": [], "val": [], "test": []}
    best_overall = None
    timer = EpochTimer(dev)
    history, eval_s, scan_info = [], [], None
    total_time = 0.0
    for rep in range(cfg.repeat):
        seed = cfg.seed if cfg.seed is not None else rep
        host_rng = np.random.default_rng(seed)
        with annotate("stage1.build"):
            model = build_model(cfg, src_d, tar_d, dev, seed)
            opts = make_optimizers(model,
                                   capturable=scan and dev.type == "cuda")
            if sharded:
                G = dataclasses.replace(G, grad_sync=GradAllReduce(
                    list(model.source_learner.parameters())
                    + list(model.target_learner.parameters()), group))
            gen = torch.Generator(device=dev).manual_seed(seed)
            # device sampling draws from a generator of its own, so that
            # its runs take the host-sampled runs' dropout masks
            sampler_gen = (torch.Generator(device=dev).manual_seed(
                _seed_of(seed, 0x5A3))
                if cfg.device_sampling else None)
            if not cfg.device_sampling:
                enus = (PairEnumerator(src_d, "train", host_rng),
                        PairEnumerator(tar_d, "train", host_rng),
                        PairEnumeratorCross(src_d, tar_d, "train", host_rng))
            evaluator = (
                DeviceStage1Evaluator(model, G, src_d, tar_d, cfg, seed)
                if use_device_evaluator(cfg)
                else Stage1Evaluator(model, G, src_d, tar_d, cfg, host_rng))
            # scan mode's train samplers (a host-sampled run reads their
            # sizes) and both domains' labels on the device
            samplers = (build_device_samplers(
                src_d, tar_d, cfg.max_class_num, cfg.sample_size,
                device=dev) if scan else None)

        best = {"epoch": -1, "train": (0, 0, 0), "val": (0, 0, 0),
                "test": (0, 0, 0), "loss": 666.0}
        best_state = None
        start_epoch = 1
        ckptr = None
        if cfg.ckpt_dir and cfg.repeat == 1:
            from bridged_gnn_tpu_torch.train.checkpoint import (
                TrainCheckpointer,
            )

            ckptr = TrainCheckpointer(cfg.ckpt_dir)
            raw = ckptr.restore() if cfg.resume else None
            if raw is not None:
                model.load_state_dict(raw["model"])
                for name, opt in opts.items():
                    load_optimizer_state(opt, raw["optimizers"][name],
                                         opt.param_groups[0]["lr"])
                gen.set_state(raw["generator"])
                if sampler_gen is not None and "sampler_generator" in raw:
                    # a host-sampled run's checkpoint holds none
                    sampler_gen.set_state(raw["sampler_generator"])
                host_rng.bit_generator.state = pickle.loads(
                    raw["host_rng_state"].numpy().tobytes())
                start_epoch = int(raw["epoch"]) + 1

        def sample_epoch() -> Dict[str, np.ndarray]:
            (i1s, i2s), (i1t, i2t), (i1c, i2c) = (
                e.sampling(cfg.max_class_num, cfg.sample_size) for e in enus)
            return {k: v.astype(np.int64) for k, v in dict(
                src1=i1s, src2=i2s, tar1=i1t, tar2=i2t, cross1=i1c,
                cross2=i2c).items()}

        def train_f1s(y_pairs, preds):
            return tuple(eval_metric(y_pairs[k].astype(int),
                                     preds[k].astype(int), cfg.metric,
                                     "binary")
                         for k in RELATIONS)

        def check_numerics(losses, epoch):
            if cfg.check_numerics:
                assert_all_finite(
                    {"loss_sim": losses,
                     "params": dict(model.named_parameters())},
                    f"stage-1 state at epoch {epoch}")

        def maybe_eval(epoch, train_scores, loss):
            nonlocal best_state
            if (epoch >= cfg.start_eval_epoch
                    and epoch % cfg.eval_per_epoch == 0):
                t_eval = time.perf_counter()
                with annotate("stage1.eval") as span:
                    scored = evaluator.scored
                    if isinstance(evaluator, DeviceStage1Evaluator):
                        val, test = evaluator.both(epoch)
                    else:
                        val = evaluator("val", epoch)
                        test = evaluator("test", epoch)
                    span.counts.update(pairs=evaluator.scored - scored)
                eval_s.append(time.perf_counter() - t_eval)
                if val[4] > best["val"][2]:
                    best.update(epoch=epoch, train=train_scores,
                                val=(val[0], val[2], val[4]),
                                test=(test[0], test[2], test[4]),
                                loss=loss)
                    with annotate("stage1.best") as span:
                        best_state = _cpu_state(model)
                        span.counts.update(bytes=sum(
                            v.numel() * v.element_size()
                            for v in best_state.values()))

        def save(epoch):
            state = dict(
                model=model.state_dict(),
                optimizers={n: o.state_dict() for n, o in opts.items()},
                generator=gen.get_state(), epoch=epoch,
                # the host sampler's state: the same pair stream on
                # resume
                host_rng_state=torch.frombuffer(bytearray(
                    pickle.dumps(host_rng.bit_generator.state)),
                    dtype=torch.uint8))
            if sampler_gen is not None:
                state["sampler_generator"] = sampler_gen.get_state()
            if primary:
                ckptr.save(epoch, state)

        t_rep = time.time()
        if scan:
            scan_info = _train_scan(
                cfg, rep, model, opts, G, gen, sampler_gen, samplers,
                sample_epoch, timer, start_epoch, history, train_f1s,
                check_numerics, maybe_eval, save if ckptr else None,
                verbose, capture)
            if rule is not None:
                scan_info["capture"] = rule
        else:
            for epoch in range(start_epoch, cfg.num_epoch + 1):
                t0 = time.time()
                with timer:
                    idxs_np = sample_epoch()
                    y_np = {rel: (y1[idxs_np[f"{rel}1"]]
                                  == y2[idxs_np[f"{rel}2"]]).astype(
                                      np.float32)
                            for rel, y1, y2 in pair_labels}
                    loss_sim, aux = sim_step(
                        model, opts, G, _to_device(idxs_np, dev),
                        _to_device(y_np, dev), cfg.use_clf, gen)
                    loss_d = d_step(model, opts, G, aux["h_src"],
                                    aux["h_tar"])
                losses = dict(loss=float(loss_sim), loss_d=float(loss_d),
                              loss_ae=float(aux["loss_ae"]))
                history.append(dict(rep=rep, epoch=epoch, **losses))
                train_scores = train_f1s(
                    y_np, {k: (aux[f"probs_{k}"] > 0.5).cpu().numpy()
                           for k in RELATIONS})
                if verbose:
                    print(f"[rep {rep}] epoch {epoch:03d} loss "
                          f"{losses['loss']:.4f} d {losses['loss_d']:.4f} "
                          f"ae {losses['loss_ae']:.4f} pair {train_scores} "
                          f"{time.time() - t0:.2f}s")
                check_numerics(loss_sim, epoch)
                maybe_eval(epoch, train_scores, losses["loss"])
                if ckptr is not None and (epoch % cfg.ckpt_every == 0
                                          or epoch == cfg.num_epoch):
                    save(epoch)
        total_time += time.time() - t_rep
        if best_state is None:
            best_state = _cpu_state(model)
        final["train"].append(best["train"])
        final["val"].append(best["val"])
        final["test"].append(best["test"])
        if best_overall is None or best["val"][2] >= best_overall[0]:
            best_overall = (best["val"][2], best_state, best, model)

    _, best_state, best, model = best_overall
    model.load_state_dict(best_state)
    model.eval()
    variables = flax_variables_from_state_dict(model, best_state)
    if ckpt_path and primary:
        with open(ckpt_path, "wb") as f:
            pickle.dump(variables, f)
    # per-repeat aggregation (reference scripts.py:545-555): mean, std and
    # best of the (src, tar, cross) pair scores across repeats
    summary = {}
    for key in ("train", "val", "test"):
        arr = np.asarray(final[key], dtype=np.float64)
        if arr.size:
            summary[key] = dict(mean=arr.mean(axis=0).tolist(),
                                std=arr.std(axis=0).tolist(),
                                best=arr.max(axis=0).tolist())
    return dict(best=best, model=model, state_dict=best_state,
                variables=variables, final=final, summary=summary,
                history=history, throughput=timer.summary(), eval_s=eval_s,
                total_time=total_time, scan=scan_info)


def _train_scan(cfg, rep, model, opts, G, gen, sampler_gen, samplers,
                sample_epoch, timer, start_epoch, history, train_f1s,
                check_numerics, maybe_eval, save, verbose,
                capture=None) -> dict:
    """One repeat's epochs in scan mode (JAX ``stage1.py:1038-1129``): the
    run's buffers and pair source (host-sampled stacks or the device
    ``samplers``, ``build_device_samplers``' pair), then stage 2's
    ``run_scan`` over :func:`segment_bounds`, with the host's work at
    every segment's end: history, train F1, numerics, evaluation and
    checkpoint. ``capture``: run_scan's rule (None: on a card)."""
    dev = G.g_src.x.device
    samplers, labels = samplers
    sizes = tuple(samplers[rel].num_pairs for rel in RELATIONS)
    i = torch.zeros(1, dtype=torch.int64, device=dev)
    if sampler_gen is not None:
        def draw():
            return sample_epoch_on_device(samplers, labels, sampler_gen)

        load, generators = None, (gen, sampler_gen)
    else:
        draw = _HostPairs(sample_epoch, sizes, cfg.scan_epochs, labels, i)
        load, generators = draw.load, (gen,)
    rows = 3 * cfg.scan_epochs
    out = torch.zeros(rows + 2 * sum(sizes), dtype=torch.float32,
                      device=dev)
    run = _ScanRun(
        model=model, G=G, opts=opts, gen=gen, generators=generators,
        use_clf=cfg.use_clf, draw=draw, i=i, out=out,
        record=out[:rows].view(-1, 3), last=out[rows:].view(2, -1))
    split_at = np.cumsum(sizes)[:-1]

    def after_segment(first, last, host):
        k = last - first + 1
        record = host[:rows].reshape(-1, 3)[:k]
        ends = host[rows:].reshape(2, -1)
        preds, ys = (dict(zip(RELATIONS, np.split(a, split_at)))
                     for a in ends)
        for j in range(k):
            history.append(dict(rep=rep, epoch=first + j,
                                loss=float(record[j, 0]),
                                loss_d=float(record[j, 1]),
                                loss_ae=float(record[j, 2])))
        train_scores = train_f1s(ys, preds)
        if verbose:
            print(f"[rep {rep}] epochs {first}-{last} loss "
                  f"{float(record[-1, 0]):.4f} pair {train_scores}")
        check_numerics(record[:, 0], last)
        maybe_eval(last, train_scores, float(record[-1, 0]))
        if save is not None:
            save(last)

    segments = segment_bounds(start_epoch, cfg)
    info = run_scan(segments, lambda: _scan_epoch(run), generators, i, timer,
                    lambda first, last: out.cpu().numpy(), after_segment,
                    load, capture=capture, spans="stage1")
    return dict(info, segments=segments)


def _to_device(arrays: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}
