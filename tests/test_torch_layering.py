"""The port's layering around the stage-2 trainer, read from the source
without importing it: what may import what from ``train/stage2.py``, and
that the trainer steps every run through one backend interface."""

import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "bridged_gnn_tpu_torch"
STAGE2 = "bridged_gnn_tpu_torch.train.stage2"


def _tree(rel: str) -> ast.Module:
    return ast.parse((PORT / rel).read_text(), filename=rel)


def _stage2_imports(tree: ast.AST) -> list:
    """What ``tree`` imports from the stage-2 trainer, at any depth: the
    names of ``from ...train.stage2 import``, and ``stage2`` for the
    module itself."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == STAGE2:
                names += [a.name for a in node.names]
            elif node.module == "bridged_gnn_tpu_torch.train":
                names += [a.name for a in node.names if a.name == "stage2"]
        elif isinstance(node, ast.Import):
            names += [a.name for a in node.names if a.name == STAGE2]
    return names


def _private_imports() -> dict:
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        private = [n for n in _stage2_imports(tree) if n.startswith("_")]
        if private:
            found[str(path.relative_to(PORT))] = private
    return found


def _function_level_imports(rel: str) -> list:
    return [(f.name, n) for f in ast.walk(_tree(rel))
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            for n in _stage2_imports(f)]


def _backend_branches(rel: str) -> list:
    """Lines comparing a ``backend`` with None by identity."""
    lines = []
    for node in ast.walk(_tree(rel)):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        named = any(isinstance(s, ast.Name) and s.id == "backend"
                    or isinstance(s, ast.Attribute) and s.attr == "backend"
                    for s in sides)
        none = any(isinstance(s, ast.Constant) and s.value is None
                   for s in sides)
        if named and none and all(isinstance(op, (ast.Is, ast.IsNot))
                                  for op in node.ops):
            lines.append(node.lineno)
    return lines


RULES = {
    "no_private_name_from_stage2": _private_imports,
    "stage1_imports_nothing_from_stage2":
        lambda: _stage2_imports(_tree("train/stage1.py")),
    "serve_imports_nothing_from_stage2":
        lambda: _stage2_imports(_tree("serve.py")),
    "stage2_runtime_imports_stage2_at_module_level":
        lambda: _function_level_imports("parallel/stage2_runtime.py"),
    "stage2_has_no_backend_is_none":
        lambda: _backend_branches("train/stage2.py"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_port_layering(rule):
    """No module of the port imports a private name of the stage-2
    trainer; stage 1 and the server import nothing of it; the sharded
    backends import it at module level only; and the trainer does not
    branch on whether a backend exists."""
    assert not RULES[rule](), (rule, RULES[rule]())
