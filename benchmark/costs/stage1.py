"""Operations of stage 1's work, counted from the domains' real sizes and
the configuration's widths: every linear's ``2·rows·in·out``, the
training step's backward at twice its forward, each epoch's share of the
run's evaluations. Gathers, norms, activations and the optimizers' own
arithmetic are not counted; nor is anything recomputed.

Stage 1 runs no hand-written kernel (the MLP backbone reads no edges),
so it has no roofline of its own.
"""

from __future__ import annotations

EQ_WIDTH = 128     # the equivalence linear's width
PAIR_WIDTH = 128   # the pair MLP's hidden width


def sizes(ctx) -> dict:
    return dict(ctx.graph)


def _mlp(rows: int, d_in: int, h: int, layers: int) -> float:
    widths = [d_in] + [h] * layers
    return sum(2.0 * rows * a * b for a, b in zip(widths, widths[1:]))


def encode_flops(s: dict) -> float:
    """Both domains' embeddings: the source backbone; the equivalence
    linear and the encoder of the target."""
    h, layers = s["h"], s["layers"]
    return (_mlp(s["n_src"], s["f_src"], h, layers)
            + 2.0 * s["n_tar"] * s["f_tar"] * EQ_WIDTH
            + _mlp(s["n_tar"], EQ_WIDTH, h, layers))


def pair_flops(s: dict, pairs: float) -> float:
    """The pair head over ``pairs`` pairs: ``2h → 128 → 1``."""
    return 2.0 * pairs * (2 * s["h"] * PAIR_WIDTH + PAIR_WIDTH)


def classify_flops(s: dict) -> float:
    return 2.0 * (s["n_src"] + s["n_tar"]) * s["h"] * s["c"]


def disc_flops(s: dict, rows: int) -> float:
    return 2.0 * rows * (s["h"] * s["h"] + s["h"])


def step_flops(s: dict) -> float:
    """One epoch's two steps: the similarity step's forward (both
    encoders, the decoder, both classifiers, the three relations' pairs,
    the discriminator on the target) and backward, the discriminator
    step's on both domains."""
    h = s["h"]
    sim = (encode_flops(s) + 2.0 * s["n_tar"] * (h * h + h * EQ_WIDTH)
           + classify_flops(s) + pair_flops(s, sum(s["pairs"]))
           + disc_flops(s, s["n_tar"]))
    return 3 * sim + 3 * disc_flops(s, s["n_src"] + s["n_tar"])


def eval_flops(s: dict) -> float:
    """One evaluation: both encodes, the two splits' pairs, the two
    classifiers once a split."""
    return (encode_flops(s) + pair_flops(s, s["eval_pairs"])
            + 2 * classify_flops(s))


def model_flops(s: dict, mode: str) -> float:
    """An epoch, with its share of the run's evaluations."""
    return step_flops(s) + eval_flops(s) * s["evals"] / s["epochs"]
