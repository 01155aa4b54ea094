"""Operations and bytes of KT-GNN's work, counted from the graph's real
sizes and the configuration's widths and dtypes.

The attention layer's least time is counted per logical operation (a
conv's attention forward; its backward with the sender-keyed reduce that
gives the tables' gradients), whatever kernels the program splits it
into: every input byte that the operation needs read once and every
output byte written once, and the arithmetic per edge. Residuals,
per-slot cotangents and tier permutations are the program's choice and
are not counted, so the count stays a lower bound however the kernels
are fused or split.
"""

from __future__ import annotations

# the hand-written kernels of the attention layer, by name in the trace
ATTENTION_KERNELS = (r"\b(attention_(fwd|bwd)(_wide)?_kernel"
                     r"|slot_reduce_kernel)\b")

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "fp8": 1}


def sizes(ctx) -> dict:
    """Nodes, edges (self loops included), features, classes, hidden
    width and the message tables' bytes per element."""
    cfg = ctx.config["stage2"]
    return dict(n=ctx.graph["n"], e=ctx.graph["e"], f=ctx.graph["f"],
                c=ctx.graph["c"], h=cfg["hidden"],
                b=_DTYPE_BYTES[ctx.config["precision"]["messages"]])


def _convs(s: dict):
    """(d_in, d_out) of each conv a forward runs: the embedding conv, the
    base head, the target head twice."""
    return [(s["f"], s["h"]), (s["h"], s["c"]), (s["h"], s["c"]),
            (s["h"], s["c"])]


def attention_forward(s: dict, d: int):
    """(operations, bytes) of one attention forward of width ``d``: the
    two message tables and the destinations' domains in, the senders of
    every edge, the aggregate out in float32; per edge the logit
    (``u[s] + u[r]``, leaky ReLU, a dot) and the weighted sum."""
    n, e, b = s["n"], s["e"], s["b"]
    return 6 * d * e, 2 * n * d * b + n + 4 * e + 4 * n * d


def attention_backward(s: dict, d: int):
    """(operations, bytes) of one attention backward with its reduce: the
    tables, domains, senders and the output's cotangent in; the two
    tables' cotangents out in float32."""
    n, e, b = s["n"], s["e"], s["b"]
    return 12 * d * e, 2 * n * d * b + n + 4 * e + 4 * n * d + 8 * n * d


def attention_ops(s: dict, mode: str):
    """The attention operations of one epoch (``train``: the training
    forward and backward and the eval forward) or one predict
    (``serve``)."""
    outs = [d_out for _, d_out in _convs(s)]
    fwd = [attention_forward(s, d) for d in outs]
    if mode == "serve":
        return fwd
    return fwd + fwd + [attention_backward(s, d) for d in outs]


def attention_least_s(s: dict, mode: str, peaks: dict) -> float:
    """Least time of an epoch's or a predict's attention work: for each
    operation the larger of its operations over the float32 peak (the
    kernels use no tensor cores) and its bytes over the memory
    bandwidth."""
    return sum(max(ops / peaks["f32"], nbytes / peaks["hbm_bytes_per_s"])
               for ops, nbytes in attention_ops(s, mode))


def forward_flops(s: dict) -> float:
    """Model operations of one full-graph forward: every conv's two gate
    projections ``[2·d_in → 1]``, its two linears and its attention, and
    the classifier transformer's two linears."""
    n, e, h = s["n"], s["e"], s["h"]
    total = 0.0
    for d_in, d_out in _convs(s):
        total += 2 * (2 * n * 2 * d_in) + 2 * (2 * n * d_in * d_out)
        total += 6 * d_out * e
    return total + 2 * (2 * n * h * h)


def model_flops(s: dict, mode: str) -> float:
    """An epoch (the training forward, its backward at twice the forward,
    the eval forward) or a predict; recomputation not counted."""
    f = forward_flops(s)
    return f if mode == "serve" else 4 * f
