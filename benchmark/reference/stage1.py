"""Plain PyTorch stage 1, the yardstick the port's adversarial similarity
learner is judged by.

Bridged-GNN's ``Adversarial_Learner_v2`` (public code
``models/models.py:1110-1142``) with the MLP backbone and the pair head,
as the port runs it: the source learner (a ``num_layer``-layer MLP
backbone with ReLU and dropout 0.5 between its linears; ``SimilarV2``'s
pair MLP, batch norm → linear → batch norm → ReLU → linear over each
pair's two embeddings side by side, and its classifier, ReLU → dropout
0.6 → linear → log-softmax), the target autoencoder (the equivalence
linear and ``tanh``, an MLP encoder like the backbone, a two-linear
decoder and ``tanh``) and the domain discriminator (linear → ReLU →
linear → sigmoid). One step is the similarity step, three pair BCEs, the
generator BCE, 0.1 × the reconstruction MSE and the two classifiers'
NLL, taken by the ``source`` and ``target`` Adams, then the
discriminator's BCE on the similarity step's embeddings, taken by the
``disc`` Adam; the forward runs in the order of the port's
``train_forward``, so the pair head's batch norms see their three
batches in the same order. Every pair gather is plain indexing; nothing
here imports the port or JAX.

Where this departs from the public code, it follows the port (and the
JAX package it was ported from): three Adams, source lr 1e-2 with L2
5e-3, target and discriminator lr 1e-3 with betas (0.5, 0.999); the
generator term's gradient on the discriminator cleared before the
discriminator's own step; PairNorm off (``norm_mode="None"``, the
recipe's); the pairs and dropout masks are the program's, read from its
run, not drawn here; initial weights ``U(±1/√fan_in)`` from one CPU
generator seeded with the run's seed in the order the port builds its
layers (the public code draws from torch's global generator).

``Precision`` chooses how the linears run: the judge in float32 with
TF32 off; the control with both operands of every linear rounded to
TF32's 10-bit mantissa first, so it runs one step below the
configuration on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
PROB_EPS = 1e-7          # the BCEs' probability clamp
HIDDEN_DROPOUT = 0.5     # between the MLP's linears
CLF_DROPOUT = 0.6        # before the classifier
EQ_WIDTH = 128           # the equivalence linear's width
PAIR_WIDTH = 128         # the pair MLP's hidden width
RELATIONS = ("src", "tar", "cross")
PAIR_KEYS = tuple(f"{r}{s}" for r in RELATIONS for s in (1, 2))
PARTS = {"source": "source_learner.", "target": "target_learner.",
         "disc": "discriminator."}
ADAMS = {"source": dict(lr=1e-2, betas=(0.9, 0.999), weight_decay=5e-3),
         "target": dict(lr=1e-3, betas=(0.5, 0.999), weight_decay=0.0),
         "disc": dict(lr=1e-3, betas=(0.5, 0.999), weight_decay=0.0)}


@dataclasses.dataclass(frozen=True)
class Precision:
    matmul: str = "f32"      # "f32" (TF32 off) or "tf32"


JUDGE = Precision()


@contextlib.contextmanager
def exact_matmuls():
    """float32 matmuls on the card: TF32 off for cuBLAS and cuDNN."""
    cublas, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = cublas.allow_tf32, cudnn.allow_tf32
    cublas.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cublas.allow_tf32, cudnn.allow_tf32 = before


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties to even),
    with the gradient passed straight through."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)
    return x + (r - x).detach()


def _linear(x, w, b, prec: Precision):
    if prec.matmul == "tf32":
        return F.linear(_tf32(x), _tf32(w), b)
    return F.linear(x, w, b)


# ------------------------------------------------------------------ inputs


def domains(src: Dict, tar: Dict, device) -> dict:
    """Both domains on ``device``: features, labels and split masks."""
    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    out = {}
    for key, d in (("src", src), ("tar", tar)):
        out[f"x_{key}"] = t(d["x"], torch.float32)
        out[f"y_{key}"] = t(d["y"], torch.int64)
        for split in ("train", "val", "test"):
            out[f"{split}_{key}"] = t(d[f"{split}_mask"], torch.bool)
    out["num_classes"] = int(out["y_src"].max()) + 1
    return out


def _mlp_shapes(prefix: str, d_in: int, widths: Sequence[int]):
    out = []
    for i, (a, b) in enumerate(zip([d_in] + list(widths[:-1]), widths)):
        out += [(f"{prefix}.layers.{i}.weight", (b, a), a),
                (f"{prefix}.layers.{i}.bias", (b,), a)]
    return out


def _linear_shapes(prefix: str, d_in: int, d_out: int):
    return [(f"{prefix}.weight", (d_out, d_in), d_in),
            (f"{prefix}.bias", (d_out,), d_in)]


BN_LAYERS = ("source_learner.sim_net.lin_self_0",
             "source_learner.sim_net.lin_self_2")


def param_shapes(f_src: int, f_tar: int, classes: int, hidden: int,
                 num_layer: int):
    """(name, shape, fan_in) of every drawn parameter, in draw order."""
    mlp = [hidden] * num_layer
    sim = "source_learner.sim_net"
    return (_mlp_shapes("source_learner.backbone_net", f_src, mlp)
            + _linear_shapes(f"{sim}.lin_self_1", 2 * hidden, PAIR_WIDTH)
            + _linear_shapes(f"{sim}.lin_self_4", PAIR_WIDTH, 1)
            + _linear_shapes(f"{sim}.lin_clf", hidden, classes)
            + _linear_shapes("target_learner.equavilent_trans_layer_0",
                             f_tar, EQ_WIDTH)
            + _mlp_shapes("target_learner.encoder", EQ_WIDTH, mlp)
            + _mlp_shapes("target_learner.decoder", hidden,
                          [hidden, EQ_WIDTH])
            + _mlp_shapes("discriminator", hidden, [hidden, 1]))


def init_state(seed: int, S: dict, hidden: int, num_layer: int,
               device) -> Params:
    """The initial weights and batch-norm state: every drawn parameter
    ``U(±1/√fan_in)`` from one CPU generator seeded with ``seed``;
    batch-norm scales 1, shifts 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    state: Params = {}
    for name, shape, fan_in in param_shapes(
            S["x_src"].shape[1], S["x_tar"].shape[1], S["num_classes"],
            hidden, num_layer):
        bound = 1.0 / math.sqrt(fan_in)
        state[name] = torch.empty(shape).uniform_(-bound, bound,
                                                  generator=gen)
    for bn, width in zip(BN_LAYERS, (2 * hidden, PAIR_WIDTH)):
        state[f"{bn}.weight"] = torch.ones(width)
        state[f"{bn}.bias"] = torch.zeros(width)
        state[f"{bn}.running_mean"] = torch.zeros(width)
        state[f"{bn}.running_var"] = torch.ones(width)
    return {k: v.to(device) for k, v in state.items()}


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def trainable(state: Params, part: Optional[str] = None) -> List[str]:
    """The trainable leaves, of one part (``PARTS``) or of all."""
    prefixes = tuple(PARTS.values()) if part is None else PARTS[part]
    return [k for k in state if not is_buffer(k) and k.startswith(prefixes)]


# ------------------------------------------------------------------- model


def _dropout(x, keep, p):
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


def _mlp(p: Params, prefix: str, x, num_layer: int, prec: Precision,
         keeps: Optional[dict] = None, site: str = "",
         taps: Optional[dict] = None):
    """Linear → ReLU → dropout → … → linear; with ``keeps`` the masks of
    ``<site>.<i>`` (the input of layer i), without them eval mode."""
    for i in range(num_layer):
        x = _linear(x, p[f"{prefix}.layers.{i}.weight"],
                    p[f"{prefix}.layers.{i}.bias"], prec)
        if i < num_layer - 1:
            x = torch.relu(x)
            if keeps is not None:
                key = f"{site}.{i + 1}"
                if taps is not None:
                    taps[key] = x.detach()
                x = _dropout(x, keeps[key], HIDDEN_DROPOUT)
    return x


def _batch_norm(p: Params, name: str, x, stats: Optional[Params]):
    """Batch statistics (the running ones updated in ``stats``) with
    ``stats``, the running ones without."""
    if stats is not None:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        n = x.shape[0]
        with torch.no_grad():
            for key, batch in (("running_mean", mean),
                               ("running_var", var * n / (n - 1))):
                stats[f"{name}.{key}"] = (
                    (1 - BN_MOMENTUM) * stats[f"{name}.{key}"]
                    + BN_MOMENTUM * batch.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    return y * p[f"{name}.weight"] + p[f"{name}.bias"]


def pair_probs(p: Params, a, b, prec: Precision,
               stats: Optional[Params] = None):
    """The pair head's probabilities for the rows ``a`` and ``b`` side by
    side."""
    sim = "source_learner.sim_net"
    z = _batch_norm(p, f"{sim}.lin_self_0", torch.cat([a, b], 1), stats)
    z = _linear(z, p[f"{sim}.lin_self_1.weight"], p[f"{sim}.lin_self_1.bias"],
                prec)
    z = torch.relu(_batch_norm(p, f"{sim}.lin_self_2", z, stats))
    z = _linear(z, p[f"{sim}.lin_self_4.weight"], p[f"{sim}.lin_self_4.bias"],
                prec)
    return torch.sigmoid(z[:, 0])


def classify(p: Params, z, prec: Precision, keep=None, site: str = "",
             taps: Optional[dict] = None):
    h = torch.relu(z)
    if keep is not None:
        if taps is not None:
            taps[site] = h.detach()
        h = _dropout(h, keep, CLF_DROPOUT)
    sim = "source_learner.sim_net"
    return torch.log_softmax(_linear(h, p[f"{sim}.lin_clf.weight"],
                                     p[f"{sim}.lin_clf.bias"], prec), -1)


def discriminate(p: Params, z, prec: Precision):
    h = torch.relu(_linear(z, p["discriminator.layers.0.weight"],
                           p["discriminator.layers.0.bias"], prec))
    return torch.sigmoid(_linear(h, p["discriminator.layers.1.weight"],
                                 p["discriminator.layers.1.bias"], prec))[:, 0]


def encode(p: Params, S: dict, num_layer: int, prec: Precision,
           keeps: Optional[dict] = None, taps: Optional[dict] = None):
    """``(h_src, h0_tar, h_tar)``: the source backbone's embeddings, the
    target's equivalence layer and encoder's."""
    h_src = _mlp(p, "source_learner.backbone_net", S["x_src"], num_layer,
                 prec, keeps, "source.backbone", taps)
    eq = "target_learner.equavilent_trans_layer_0"
    h0 = torch.tanh(_linear(S["x_tar"], p[f"{eq}.weight"], p[f"{eq}.bias"],
                            prec))
    h_tar = _mlp(p, "target_learner.encoder", h0, num_layer, prec, keeps,
                 "target.encoder", taps)
    return h_src, h0, h_tar


def _bce(probs, targets):
    q = probs.clamp(PROB_EPS, 1 - PROB_EPS)
    return -(targets * torch.log(q) + (1 - targets) * torch.log(1 - q)).mean()


def _nll(lp, y, mask):
    picked = lp.gather(1, y.clamp(min=0)[:, None])[:, 0]
    m = mask.to(lp.dtype)
    return -(picked * m).sum() / m.sum().clamp(min=1.0)


def sim_loss(p: Params, S: dict, idxs: dict, y: dict, keeps: dict,
             num_layer: int, prec: Precision, stats: Params,
             taps: Optional[dict] = None):
    """The similarity step's loss in ``train_forward``'s order, its
    autoencoder part and the embeddings the discriminator step takes."""
    h_src, h0, h_tar = encode(p, S, num_layer, prec, keeps, taps)
    lp_src = classify(p, h_src, prec, keeps["clf.source"], "clf.source",
                      taps)
    probs = {"src": pair_probs(p, h_src[idxs["src1"]], h_src[idxs["src2"]],
                               prec, stats)}
    d = "target_learner.decoder"
    r = torch.relu(_linear(h_tar, p[f"{d}.layers.0.weight"],
                           p[f"{d}.layers.0.bias"], prec))
    recons = torch.tanh(_linear(r, p[f"{d}.layers.1.weight"],
                                p[f"{d}.layers.1.bias"], prec))
    lp_tar = classify(p, h_tar, prec, keeps["clf.target"], "clf.target",
                      taps)
    probs["tar"] = pair_probs(p, h_tar[idxs["tar1"]], h_tar[idxs["tar2"]],
                              prec, stats)
    probs["cross"] = pair_probs(p, h_src[idxs["cross1"]],
                                h_tar[idxs["cross2"]], prec, stats)
    d_tar = discriminate(p, h_tar, prec).clamp(PROB_EPS, 1 - PROB_EPS)
    n_tar = h_tar.shape[0]
    loss_recons = ((recons - h0) ** 2).sum() / (n_tar * recons.shape[1])
    loss_g = -torch.log(d_tar).sum() / n_tar
    loss_ae = loss_g + loss_recons * 0.1
    loss = sum(_bce(probs[r], y[r]) for r in RELATIONS) + loss_ae
    loss = loss + _nll(lp_src, S["y_src"], S["train_src"])
    loss = loss + _nll(lp_tar, S["y_tar"], S["train_tar"])
    return loss, loss_ae, h_src.detach(), h_tar.detach()


def d_loss(p: Params, h_src, h_tar, prec: Precision):
    """Real = the source's rows, fake = the target's."""
    real = -torch.log(discriminate(p, h_src, prec).clamp(
        PROB_EPS, 1 - PROB_EPS)).mean()
    fake = -torch.log((1 - discriminate(p, h_tar, prec)).clamp(
        PROB_EPS, 1 - PROB_EPS)).mean()
    return (real + fake) / 2


# --------------------------------------------------------------- training


class Adam:
    """torch ``Adam`` over one part's leaves: L2 added to the gradient,
    bias corrections. It may start after ``t`` steps, from the moments
    ``m`` and ``v`` those steps left."""

    def __init__(self, names: Sequence[str], lr: float, betas,
                 weight_decay: float, eps: float = 1e-8, t: int = 0,
                 m: Optional[Params] = None, v: Optional[Params] = None):
        self.names = list(names)
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.m: Params = dict(m or {})
        self.v: Params = dict(v or {})
        self.t = t

    def step(self, state: Params, grads: Params) -> Params:
        """Apply one step; returns the gradients as the moments took them
        (the L2 term included)."""
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        with torch.no_grad():
            for k in self.names:
                g = grads[k] + self.wd * state[k] if self.wd else grads[k]
                taken[k] = g
                self.m[k] = self.b1 * self.m.get(k, 0) + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v.get(k, 0) + (1 - self.b2) * g * g
                denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
                state[k] = state[k] - (self.lr / bc1) * self.m[k] / denom
        return taken


FAULTS = ("disc_skipped", "generator_grad", "frozen_adam")


def train_steps(state: Params, S: dict, num_layer: int, steps: list,
                prec: Precision, fault: Optional[str] = None,
                moments: Optional[dict] = None) -> dict:
    """``len(steps)`` epochs from ``state``, each given as ``(idxs, y,
    keeps)``: the epoch's pairs, their targets and its dropout masks.
    ``moments``: by part, the Adam's ``(t, m, v)`` from the steps before
    (none: a fresh run). Returns each epoch's losses ``(sim, d, ae)`` at
    the weights before it, the layers before each dropout, the first
    epoch's gradients as the Adams took them, and the state after the
    last epoch (batch-norm running statistics included). ``fault`` plants
    one the comparison has to catch: ``disc_skipped`` the discriminator
    never steps, ``generator_grad`` its step takes the generator term's
    gradient too, ``frozen_adam`` the target Adam never steps."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    state = {k: v.clone() for k, v in state.items()}
    moments = moments or {}
    opts = {part: Adam(trainable(state, part), **ADAMS[part],
                       **dict(zip("tmv", moments.get(part, (0, None, None)))))
            for part in PARTS}
    sim_names = trainable(state, "source") + trainable(state, "target")
    disc_names = trainable(state, "disc")
    losses, pre, first = [], [], None
    with exact_matmuls():
        for idxs, y, keeps in steps:
            p = {k: (v.detach().requires_grad_(True) if not is_buffer(k)
                     else v) for k, v in state.items()}
            stats = {k: v for k, v in state.items() if is_buffer(k)}
            taps: dict = {}
            loss, loss_ae, h_src, h_tar = sim_loss(p, S, idxs, y, keeps,
                                                   num_layer, prec, stats,
                                                   taps)
            g = torch.autograd.grad(loss, [p[k] for k in sim_names
                                           + disc_names])
            grads = dict(zip(sim_names + disc_names, g))
            state.update(stats)
            taken = opts["source"].step(state, grads)
            if fault != "frozen_adam":
                taken.update(opts["target"].step(state, grads))
            else:
                taken.update({k: grads[k] for k in opts["target"].names})
            pd = {k: state[k].detach().requires_grad_(True)
                  for k in disc_names}
            value_d = d_loss(pd, h_src, h_tar, prec)
            dg = dict(zip(disc_names, torch.autograd.grad(
                value_d, [pd[k] for k in disc_names])))
            if fault == "generator_grad":
                dg = {k: dg[k] + grads[k] for k in disc_names}
            if fault != "disc_skipped":
                taken.update(opts["disc"].step(state, dg))
            else:
                taken.update(dg)
            losses.append((float(loss.detach()), float(value_d.detach()),
                           float(loss_ae.detach())))
            pre.append(taps)
            if first is None:
                first = taken
    return dict(losses=losses, pre=pre, grad1=first, state=state)


def eval_counts(p: Params, S: dict, num_layer: int,
                pairs: Dict[str, Dict[str, Tuple[torch.Tensor, ...]]],
                prec: Precision = JUDGE) -> Dict[str, torch.Tensor]:
    """The device evaluator's counts of each split in ``pairs`` (relation
    → the pair's two id tensors), flat in its layout: per relation ``tp``,
    ``pred`` and ``true`` of the two classes of ``prob > 0.5`` against
    label equality; then per domain the classifier's per-class counts over
    the split's rows, a last bin for ``y == -1``."""
    with exact_matmuls(), torch.no_grad():
        h_src, _, h_tar = encode(p, S, num_layer, prec)
        z = {"src": h_src, "tar": h_tar}
        side = {"src": ("src", "src"), "tar": ("tar", "tar"),
                "cross": ("src", "tar")}
        out = {}
        for split, by_rel in pairs.items():
            parts = []
            for rel in RELATIONS:
                a, b = by_rel[rel]
                d1, d2 = side[rel]
                pred = (pair_probs(p, z[d1][a], z[d2][b], prec) > 0.5).long()
                truth = (S[f"y_{d1}"][a] == S[f"y_{d2}"][b]).long()
                parts.append(_counts(pred, truth, torch.ones_like(pred), 2))
            for d in ("src", "tar"):
                y = S[f"y_{d}"]
                bins = int(y.max()) + 2
                y_bin = torch.where(y < 0, bins - 1, y)
                pred = classify(p, z[d], prec).argmax(1)
                parts.append(_counts(pred, y_bin, S[f"{split}_{d}"].long(),
                                     bins))
            out[split] = torch.cat(parts)
    return out


def _counts(pred, truth, mask, bins: int) -> torch.Tensor:
    c = torch.arange(bins, device=pred.device)
    p = (pred[:, None] == c).long() * mask[:, None]
    t = (truth[:, None] == c).long()
    return torch.cat([(p * t).sum(0), p.sum(0), (t * mask[:, None]).sum(0)])
