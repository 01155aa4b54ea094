"""Plain PyTorch KT-GNN, the yardstick the port's KT-GNN is judged by.

The model of the reference ``models/KTGNN.py`` as the port runs it with
``num_layer=2``: one domain-adapted attention conv, batch norm, ReLU and
dropout; the base head, the classifier transformer and the target head
applied to both embeddings; three log-softmaxes. The four-term loss, torch
Adam with L2 weight decay and StepLR. Every aggregation is a gather and an
``index_add`` over the edge list; nothing here calls a kernel of the port
or imports it. The graph (symmetrised, coalesced, one self loop per node)
and the initial weights (uniform, drawn from a CPU ``torch.Generator``
seeded with the configuration's seed, in the order the port builds its
layers) are worked out here again from the inputs the benchmark made.

``Precision`` chooses how the linears and the message tables are
computed: the judge runs both in float32 with TF32 off; the control runs
them one step below what the configuration states (bfloat16 matmuls for
TF32, float8 e4m3 message tables for bfloat16 ones).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

NEG_SLOPE = 0.1
BETAS = (0.9, 0.999)   # torch Adam's defaults, as the recipe uses them
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@dataclasses.dataclass(frozen=True)
class Precision:
    matmul: str = "f32"      # "f32" (TF32 off) or "bf16"
    messages: str = "f32"    # "f32", "bf16" or "fp8"


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


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` stored in ``dtype`` and read back. float8 is scaled per
    tensor by its largest magnitude (the usual fp8 recipe), so small
    cotangents do not flush to zero."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype).to(x.dtype)
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    """A message table stored in ``dtype`` on the way forward and its
    cotangent on the way back (as the attention kernels keep both in the
    tables' dtype), in float32 storage."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _rounded(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, ctx.dtype), None


_MESSAGE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _round_messages(u: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.messages == "f32":
        return u
    return _Round.apply(u, _MESSAGE_DTYPES[prec.messages])


def _linear(x, w, b, prec: Precision):
    if prec.matmul == "bf16":
        return F.linear(x.bfloat16(), w.bfloat16(),
                        None if b is None else b.bfloat16()).float()
    return F.linear(x, w, b)


# ------------------------------------------------------------------ inputs


def prepare_graph(data: Dict[str, np.ndarray], to_undirected: bool,
                  device) -> dict:
    """The training graph on ``device``: edges symmetrised and coalesced
    (PyG ``ToUndirected``), self loops removed and one added per node;
    unlabeled nodes out of the train split."""
    x = np.asarray(data["x"], np.float32)
    n = x.shape[0]
    ei = np.asarray(data["edge_index"], np.int64)
    if to_undirected:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
        key = np.unique(ei[1] * n + ei[0])
        ei = np.stack([key % n, key // n])
    ei = ei[:, ei[0] != ei[1]]
    loops = np.arange(n, dtype=np.int64)
    src = np.concatenate([ei[0], loops])
    dst = np.concatenate([ei[1], loops])
    y = np.asarray(data["y"], np.int64)

    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    central = t(np.asarray(data["central_mask"], bool))
    r = t(dst)
    return dict(
        n=n, x=t(x), y=t(y), central=central,
        train=t(np.asarray(data["train_mask"], bool) & (y != -1)),
        val=t(np.asarray(data["val_mask"], bool)),
        test=t(np.asarray(data["test_mask"], bool)),
        s=t(src), r=r, c_r=central[r], num_edges=int(len(src)),
        num_classes=int(y.max()) + 1)


def _conv_shapes(prefix: str, d_in: int, d_out: int):
    """An AdaptedConv's parameters in the order the port draws them."""
    return [
        (f"{prefix}.a_g_s2t.weight", (1, 2 * d_in), 2 * d_in),
        (f"{prefix}.a_g_t2s.weight", (1, 2 * d_in), 2 * d_in),
        (f"{prefix}.lin_t.weight", (d_out, d_in), d_in),
        (f"{prefix}.lin_t.bias", (d_out,), d_in),
        (f"{prefix}.lin_s.weight", (d_out, d_in), d_in),
        (f"{prefix}.lin_s.bias", (d_out,), d_in),
        (f"{prefix}.a_f_t2s", (d_out,), d_out),
        (f"{prefix}.a_f_s2t", (d_out,), d_out),
    ]


def param_shapes(in_channels: int, hidden: int, num_classes: int):
    """(name, shape, fan_in) of every drawn parameter, in draw order."""
    return (_conv_shapes("convs.0", in_channels, hidden)
            + _conv_shapes("clf_base", hidden, num_classes)
            + _conv_shapes("clf_target", hidden, num_classes)
            + [("clf_transformer.lin_0.weight", (hidden, hidden), hidden),
               ("clf_transformer.lin_0.bias", (hidden,), hidden),
               ("clf_transformer.lin_3.weight", (hidden, hidden), hidden),
               ("clf_transformer.lin_3.bias", (hidden,), hidden)])


BN_LAYERS = ("bns.0", "clf_transformer.bn_1")


def init_state(seed: int, in_channels: int, hidden: int, num_classes: int,
               device) -> Params:
    """The initial weights and batch-norm state: every drawn parameter
    ``U(±1/√fan_in)`` from one CPU generator seeded with ``seed``;
    batch-norm scales 1, shifts 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    state: Params = {}
    for name, shape, fan_in in param_shapes(in_channels, hidden,
                                            num_classes):
        bound = 1.0 / math.sqrt(fan_in)
        state[name] = torch.empty(shape).uniform_(-bound, bound,
                                                  generator=gen)
    for bn in BN_LAYERS:
        state[f"{bn}.weight"] = torch.ones(hidden)
        state[f"{bn}.bias"] = torch.zeros(hidden)
        state[f"{bn}.running_mean"] = torch.zeros(hidden)
        state[f"{bn}.running_var"] = torch.ones(hidden)
    return {k: v.to(device) for k, v in state.items()}


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# ------------------------------------------------------------------- model


def _conv(p: Params, prefix: str, x: torch.Tensor, G: dict,
          prec: Precision) -> torch.Tensor:
    central = G["central"]
    target = ~central
    dd = (x[central].mean(0) - x[target].mean(0))[None]
    gcat = torch.cat([x, dd.expand_as(x)], dim=-1)
    sh_s2t = torch.tanh(_linear(gcat, p[f"{prefix}.a_g_s2t.weight"], None,
                                prec)) * dd
    sh_t2s = torch.tanh(_linear(gcat, p[f"{prefix}.a_g_t2s.weight"], None,
                                prec)) * dd
    x_s2t = x - sh_s2t * central[:, None].to(x.dtype)
    x_t2s = x + sh_t2s * target[:, None].to(x.dtype)
    u_s2t = _round_messages(_linear(x_s2t, p[f"{prefix}.lin_t.weight"],
                                    p[f"{prefix}.lin_t.bias"], prec), prec)
    u_t2s = _round_messages(_linear(x_t2s, p[f"{prefix}.lin_s.weight"],
                                    p[f"{prefix}.lin_s.bias"], prec), prec)
    # GATv2 attention: a central destination attends over the t2s
    # messages with a_f_t2s, a target one over the s2t messages
    s, r, c_r, n = G["s"], G["r"], G["c_r"], G["n"]
    sel = c_r[:, None]
    m = torch.where(sel, u_t2s[s], u_s2t[s])
    h = F.leaky_relu(m + torch.where(sel, u_t2s[r], u_s2t[r]), NEG_SLOPE)
    logit = torch.where(c_r, h @ p[f"{prefix}.a_f_t2s"],
                        h @ p[f"{prefix}.a_f_s2t"])
    with torch.no_grad():
        mx = logit.new_full((n,), -math.inf).scatter_reduce(
            0, r, logit, reduce="amax")
    e = torch.exp(logit - mx[r])
    den = e.new_zeros(n).index_add(0, r, e)
    out = m.new_zeros(n, m.shape[1]).index_add(0, r, e[:, None] * m)
    return out / den[:, None]


def _batch_norm(p: Params, name: str, x: torch.Tensor, train: bool,
                stats: Optional[Params]) -> torch.Tensor:
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        if stats is not None:
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


def heads(p: Params, G: dict, prec: Precision = JUDGE,
          keep: Optional[torch.Tensor] = None, dropout: float = 0.5,
          stats: Optional[Params] = None, x: Optional[torch.Tensor] = None,
          taps: Optional[dict] = None):
    """The three heads' log-probabilities ``(source, target,
    target_hat)``. With ``keep`` (a bool mask of the hidden layer) the
    train-mode forward: batch statistics (the running ones updated in
    ``stats``), dropout by ``keep`` scaled by ``1/(1-dropout)``; without
    it the eval-mode forward. ``x`` replaces the graph's features.
    ``taps["pre"]`` receives the hidden layer before dropout."""
    train = keep is not None
    h = _conv(p, "convs.0", G["x"] if x is None else x, G, prec)
    h = torch.relu(_batch_norm(p, "bns.0", h, train, stats))
    if taps is not None:
        taps["pre"] = h.detach()
    if train:
        h = h * keep.to(h.dtype) * (1.0 / (1.0 - dropout))
    base = _conv(p, "clf_base", h, G, prec)
    t = _linear(h, p["clf_transformer.lin_0.weight"],
                p["clf_transformer.lin_0.bias"], prec)
    t = torch.relu(_batch_norm(p, "clf_transformer.bn_1", t, train, stats))
    t = _linear(t, p["clf_transformer.lin_3.weight"],
                p["clf_transformer.lin_3.bias"], prec)
    target_hat = _conv(p, "clf_target", t, G, prec)
    target = _conv(p, "clf_target", h, G, prec)
    return (torch.log_softmax(base, 1), torch.log_softmax(target, 1),
            torch.log_softmax(target_hat, 1))


def _nll(lp, y, mask):
    picked = lp.gather(1, y.clamp(min=0)[:, None])[:, 0]
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)


def loss(lps, G: dict, lam: float, train_rows: Optional[torch.Tensor] = None):
    """``(2·L_s + L_t + L_t̂)/4 + λ·KL(t̂ ‖ t)``: NLLs over the train split
    (the target ones over its target rows), the KL's batch mean over every
    node. ``train_rows`` replaces the train split."""
    lp_s, lp_t, lp_that = lps
    train = (G["train"] if train_rows is None else train_rows).float()
    tar = train * (~G["central"]).float()
    kl = (torch.exp(lp_t) * (lp_t - lp_that)).sum() / G["n"]
    return ((2.0 * _nll(lp_s, G["y"], train) + _nll(lp_t, G["y"], tar)
             + _nll(lp_that, G["y"], tar)) / 4.0 + lam * kl)


# --------------------------------------------------------------- training


def trainable(state: Params) -> List[str]:
    return [k for k in state if not is_buffer(k)]


class Adam:
    """torch ``Adam(weight_decay=wd)``: L2 added to the gradient, bias
    corrections, StepLR's rate ``lr·γ^⌊(t−1)/step⌋`` at step t. It may
    start after ``t`` steps, from the moments ``m`` and ``v`` those steps
    left. ``stale_rate`` plants a fault: StepLR never steps."""

    def __init__(self, names: Sequence[str], cfg: dict,
                 betas=BETAS, eps: float = 1e-8, t: int = 0,
                 m: Optional[Params] = None, v: Optional[Params] = None,
                 stale_rate: bool = False):
        self.names, self.cfg = list(names), cfg
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m: Params = dict(m or {})
        self.v: Params = dict(v or {})
        self.t = t
        self.stale_rate = stale_rate

    def rate(self) -> float:
        c = self.cfg
        if not c["use_scheduler"] or self.stale_rate:
            return c["lr"]
        return c["lr"] * c["gamma"] ** ((self.t - 1) // c["step_size"])

    def step(self, state: Params, grads: Params) -> Params:
        """Apply one step; returns the gradients as the moments took them
        (the L2 term included)."""
        self.t += 1
        lr, wd = self.rate(), self.cfg["weight_decay"]
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        with torch.no_grad():
            for k in self.names:
                g = grads[k] + wd * state[k]
                taken[k] = g
                self.m[k] = self.b1 * self.m.get(k, 0) + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v.get(k, 0) + (1 - self.b2) * g * g
                denom = (self.v[k] / bc2).sqrt() + self.eps
                state[k] = state[k] - lr * (self.m[k] / bc1) / denom
        return taken


FAULTS = ("half_batch", "frozen", "stale_rate")


def train_steps(state: Params, G: dict, cfg: dict, keeps, prec: Precision,
                fault: Optional[str] = None, done: int = 0,
                moments: Optional[tuple] = None) -> dict:
    """``len(keeps)`` training steps from ``state`` with the dropout masks
    ``keeps``, after ``done`` steps that left Adam's ``moments`` ``(m,
    v)``: each step's loss at the weights before it, the hidden layer
    before each step's dropout, the first step's gradients as Adam took
    them, and the state after the last step (batch-norm running
    statistics included). ``fault`` plants one the comparison has to
    catch: ``half_batch`` a train split of half the rows, ``frozen`` steps
    that leave the state as it was, ``stale_rate`` a rate StepLR never
    lowers."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    state = {k: v.clone() for k, v in state.items()}
    names = trainable(state)
    m, v = moments if moments is not None else (None, None)
    opt = Adam(names, cfg, t=done, m=m, v=v,
               stale_rate=fault == "stale_rate")
    rows = half_rows(G["train"]) if fault == "half_batch" else None
    losses, pre, first = [], [], None
    with exact_matmuls():
        for keep in keeps:
            p = {k: (v.detach().requires_grad_(True) if k in names else v)
                 for k, v in state.items()}
            stats = {k: v for k, v in state.items() if is_buffer(k)}
            taps: dict = {}
            value = loss(heads(p, G, prec, keep, cfg["dropout"], stats, taps=taps),
                         G, cfg["Lambda"], rows)
            grads = dict(zip(names, torch.autograd.grad(
                value, [p[k] for k in names])))
            losses.append(float(value.detach()))
            pre.append(taps["pre"])
            if fault == "frozen":
                taken = {k: grads[k] + cfg["weight_decay"] * state[k]
                         for k in names}
            else:
                state.update(stats)
                taken = opt.step(state, grads)
            if first is None:
                first = taken
    return dict(losses=losses, pre=pre, grad1=first, state=state)


def scores(p: Params, G: dict, prec: Precision = JUDGE) -> Dict[str, float]:
    """The trainer's scores of an epoch, from the eval forward at ``p``:
    macro F1 of the source head on the train split and of the
    target-hat head on val and test, over the labels present in the
    split's truth or predictions."""
    with exact_matmuls(), torch.no_grad():
        lp_s, _, lp_that = heads(p, G, prec)
    out = {}
    for split, lp in (("train", lp_s), ("val", lp_that), ("test", lp_that)):
        mask = G[split]
        out[split] = macro_f1(G["y"][mask], lp[mask].argmax(1))
    return out


def macro_f1(y: torch.Tensor, pred: torch.Tensor) -> float:
    """sklearn's ``f1_score(average="macro")``: per label ``2·tp / (pred
    + true)``, the mean over every label in ``y`` or ``pred``."""
    size = int(max(int(y.max()), int(pred.max()))) + 1 if len(y) else 0
    tp = torch.bincount(y[pred == y], minlength=size).double()
    both = (torch.bincount(pred, minlength=size)
            + torch.bincount(y, minlength=size)).double()
    present = both > 0
    if not bool(present.any()):
        return 0.0
    return float((2 * tp[present] / both[present]).mean())


def half_rows(mask: torch.Tensor) -> torch.Tensor:
    """Every other row of ``mask`` left out."""
    out = mask.clone()
    rows = torch.nonzero(mask)[:, 0]
    out[rows[::2]] = False
    return out
