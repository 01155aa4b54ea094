"""The program's hand-written kernels, by the names its sources give
them: every ``__global__`` function of its CUDA sources and every
``@triton.jit`` function of its Python files, read at run time so that a
kernel a later change adds counts as hand-written without an edit here."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

_CUDA = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                   r"(\w+)")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*def\s+(\w+)")


def hand_written(package: Path) -> List[str]:
    names = set()
    for path in package.rglob("*.cu"):
        names.update(_CUDA.findall(path.read_text()))
    for path in package.rglob("*.cuh"):
        names.update(_CUDA.findall(path.read_text()))
    for path in package.rglob("*.py"):
        text = path.read_text()
        if "triton.jit" in text:
            names.update(_TRITON.findall(text))
    return sorted(names)


def pattern(names: List[str]) -> str:
    """A regular expression that finds any of ``names`` in a trace's
    kernel name."""
    return r"\b(" + "|".join(map(re.escape, names)) + r")\b" if names \
        else r"(?!)"
