"""Numerics and determinism sanitizers (port of
``bridged_gnn_tpu/utils/sanitizers.py``, for tensors and numpy arrays).

  * :func:`assert_all_finite`: the finite-state guard. The trainer's
    ``check_numerics`` runs it on the losses, the parameters and the
    batch-norm statistics at every epoch of the loop and at every chunk
    boundary of scan mode;
  * :func:`check_determinism`: run a function twice on the same inputs
    and assert bit-identical outputs;
  * :func:`nan_debug`: a context in which the first operation that gives
    a non-finite value raises (debugging only: it reads every result).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every tensor or array in nested dicts, lists
    and tuples, in their order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` that holds a NaN or an infinity. Tensors are checked where
    they lie; the verdicts reach the host in one copy."""
    floats = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf) if not torch.is_tensor(leaf) else leaf
        if t.is_floating_point():
            floats.append((path, t))
    if not floats:
        return
    # gather the verdicts on a card if any leaf lies there
    dev = next((t.device for _, t in floats if t.device.type != "cpu"),
               torch.device("cpu"))
    finite = torch.stack([torch.isfinite(t).all().to(dev)
                          for _, t in floats]).cpu().numpy()
    if not finite.all():
        path = floats[int(np.argmin(finite))][0]
        raise FloatingPointError(f"non-finite values in {name} at {path}")


def check_determinism(fn: Callable, *args, runs: int = 2, **kwargs) -> None:
    """Call ``fn(*args, **kwargs)`` ``runs`` times and raise
    ``AssertionError`` unless every tensor or array of the outputs
    (nested dicts, lists and tuples) is bit-identical to the first run's,
    NaNs in the same places."""

    def host(tree):
        return [(p, np.asarray(v.detach().cpu() if torch.is_tensor(v) else v))
                for p, v in _leaves(tree)]

    ref = host(fn(*args, **kwargs))
    for _ in range(runs - 1):
        out = host(fn(*args, **kwargs))
        for (path, a), (_, b) in zip(ref, out):
            if not np.array_equal(a, b, equal_nan=True):
                diff = np.max(np.abs(a.astype(np.float64)
                                     - b.astype(np.float64)))
                raise AssertionError(
                    f"nondeterministic output at {path or 'the result'}: "
                    f"max abs diff {diff}")


class _NonFiniteGuard(torch.overrides.TorchFunctionMode):
    """Raises at the first torch function whose floating result holds a
    NaN or an infinity."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for path, t in _leaves(out):
            if (torch.is_tensor(t) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                name = getattr(func, "__name__", repr(func))
                raise FloatingPointError(
                    f"non-finite values from {name}{path}")
        return out


@contextlib.contextmanager
def nan_debug() -> Iterator[None]:
    """Run the block with every torch function's result checked (JAX
    ``jax_debug_nans``): the first one holding a NaN or an infinity
    raises ``FloatingPointError`` naming it; backward passes run under
    ``torch.autograd`` anomaly detection, which raises at the first
    backward function that returns a NaN. Every check waits for the
    device: for debugging, not inside a CUDA graph's capture."""
    with _NonFiniteGuard(), torch.autograd.set_detect_anomaly(True):
        yield
