"""Device time of one eager KT-GNN epoch and one served forward, grouped by
the source line of ``nn/ktgnn.py`` and ``nn/common.py`` that launched it.

Runs the benchmark's ``ktgnn`` configuration (131,072 nodes, 16 edges a
node, 256 features, 31 classes, hidden 64, bf16 messages, TF32 matmuls)
on the card under ``torch.profiler(with_stack=True)``:

* ``train``: one eager epoch (``train_ktgnn`` in loop mode, one epoch:
  the train forward, its backward, Adam and the eval forward), after a
  two-epoch warm-up run;
* ``serve``: ``KTGNNPredictor.predict_live`` with 256 new rows, the mean
  of ``--requests`` requests after three warm-up ones.

``device_ms`` counts kernels and memsets; copies between host and card
(the graph's upload, the heads' copy back) are ``copy_ms`` and rows of
their own. Every device op's time goes to the Python frame that launched
it (from the Chrome trace: the kernel's launch, the ``python_function``
ranges around it on its thread): the innermost frame of ``nn/ktgnn.py``,
``nn/common.py``, ``ops/fused_attention.py`` or ``ops/conv_prologue.py``
(a frame is named by its function's first line), with the PyTorch op
that launched it. An op of the backward, which has no Python frame, goes
to the frame of the forward op whose autograd node it runs (``bwd`` rows,
matched by sequence number). The hand-written kernels are listed by
name. Rows of ``AdaptedConv``'s prologue (``_branch``, the ops
``_forward`` and ``_halo_forward`` run themselves, the masked means under
them, ``ops/conv_prologue.py`` and its kernels) are marked
``prologue``.

    python3 tools/torch_prologue_profile.py [--requests 5] [--out DIR]

Prints one JSON line per mode and writes the full tables to
``DIR/prologue_profile.json`` and the two Chrome traces beside them
(default ``_profiles``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bridged_gnn_tpu_torch.data.synthetic import (  # noqa: E402
    make_benchmark_graph,
)
from bridged_gnn_tpu_torch.serve import KTGNNPredictor  # noqa: E402
from bridged_gnn_tpu_torch.train.stage2 import (  # noqa: E402
    Stage2Config,
    build_model,
    train_ktgnn,
)

_OURS = re.compile(r"(nn/(?:ktgnn|common)\.py|ops/(?:fused_attention|"
                   r"conv_prologue)\.py)\((\d+)\): (\w+)")
STAGE2 = dict(model_name="KTGNN", num_layer=2, hidden=64, lr=1e-3,
              weight_decay=5e-3, use_scheduler=True, step_size=100,
              gamma=0.1, Lambda=1.0, dropout=0.5, use_bn=True,
              to_undirected=True, adjacency_method="auto",
              matmul_precision="default", message_dtype="bfloat16")
# A row is the prologue's when its frame of nn/ktgnn.py is one of these
# (file, function) and its innermost frame of ours is not the attention's.
_PROLOGUE = {("nn/ktgnn.py", "_branch"), ("nn/ktgnn.py", "_forward"),
             ("nn/ktgnn.py", "_halo_forward")}


def _innermost(intervals, queries):
    """For each query ``(t, q)`` the chain of ``intervals`` ``(ts, end,
    name)`` (properly nested, one thread) that hold ``t``, outermost
    first."""
    intervals = sorted(intervals, key=lambda v: (v[0], -v[1]))
    out, stack, i = {}, [], 0
    for t, q in sorted(queries):
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = [v[2] for v in stack]
    return out


def frame_key(chain) -> str:
    """The innermost frame of ours on a Python chain (outermost first),
    with the innermost frame of ``nn/ktgnn.py`` above it when that is
    another."""
    ours = [m for m in (_OURS.search(f) for f in chain) if m]
    if not ours:
        return ""
    inner = ours[-1]
    ktg = next((m for m in reversed(ours) if m.group(1) == "nn/ktgnn.py"),
               None)
    parts = [inner] if ktg is None or ktg is inner else [ktg, inner]
    return " / ".join(f"{m.group(1)}({m.group(2)}): {m.group(3)}"
                      for m in parts)


def is_prologue(key: str) -> bool:
    frames = re.findall(r"([\w/]+\.py)\(\d+\): (\w+)", key)
    if not frames:
        return False
    inner = frames[-1]
    return inner[0] == "ops/conv_prologue.py" or (
        frames[0] in _PROLOGUE and inner[0] != "ops/fused_attention.py")


def attribute(trace_path: Path, scale: float) -> dict:
    """Device ms by launching frame and op from a Chrome trace of
    ``torch.profiler`` with ``with_stack=True``."""
    evs = json.loads(trace_path.read_text())["traceEvents"]
    py, ops, launch = defaultdict(list), defaultdict(list), {}
    kernels = []
    for e in evs:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        iv = (e["ts"], e["ts"] + e.get("dur", 0), e["name"])
        if cat == "python_function":
            py[e["tid"]].append(iv)
        elif cat == "cpu_op":
            ops[e["tid"]].append(iv + (e["args"].get("Sequence number",
                                                     -1),))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], e["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append(e)
    by_tid = defaultdict(list)
    for k, e in enumerate(kernels):
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is not None:
            by_tid[where[0]].append((where[1], k))
    chains, opchains = {}, {}
    for tid, qs in by_tid.items():
        chains.update(_innermost(py[tid], qs))
        opchains.update(_innermost([v[:2] + (v,) for v in ops[tid]], qs))
    # forward ops' keys by sequence number, for the backward's rows
    fwd = {}
    for tid, vs in ops.items():
        seq = [(v[0], i) for i, v in enumerate(vs) if v[3] >= 0
               and not v[2].startswith("autograd::")]
        ch = _innermost(py[tid], seq)
        for t, i in seq:
            key = frame_key(ch[i])
            if key:
                fwd.setdefault(vs[i][3], key)
    rows = defaultdict(float)
    total = copies = 0.0
    for k, e in enumerate(kernels):
        dur = e.get("dur", 0)
        name = e["name"]
        if e.get("cat") == "gpu_memcpy":
            copies += dur
            rows["copy | " + name] += dur
            continue
        total += dur
        if re.search(r"conv_prologue|attention_|slot_reduce|gather_reduce",
                     name):
            short = re.sub(r"^void |\(anonymous namespace\)::", "", name)
            rows["kernel | " + re.split(r"[<(]", short)[0]] += dur
            continue
        key = frame_key(chains.get(k, []))
        opc = opchains.get(k, [])
        op = opc[-1][2] if opc else "?"
        if key:
            rows["fwd " + key + " | " + op] += dur
            continue
        ev = next((v for v in reversed(opc)
                   if v[2].startswith("autograd::engine::evaluate_function")),
                  None)
        if ev is not None:
            node = ev[2].split(": ", 1)[-1]
            rows["bwd " + fwd.get(ev[3], "?") + " | " + node] += dur
        else:
            rows["other | " + op] += dur
    table = [dict(key=key, ms=t / 1e3 * scale, prologue=is_prologue(
                 key.split(" | ")[0]) if not key.startswith(("kernel",
                                                             "copy"))
                 else "conv_prologue" in key)
             for key, t in sorted(rows.items(), key=lambda kv: -kv[1])]
    prologue_ms = sum(r["ms"] for r in table if r["prologue"])
    device_ms = total / 1e3 * scale
    return dict(device_ms=device_ms, copy_ms=copies / 1e3 * scale,
                prologue_ms=prologue_ms,
                prologue_share=prologue_ms / max(device_ms, 1e-9),
                rows=table)


def profiled(fn, path: Path) -> Path:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="_profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    data = make_benchmark_graph(131072, 16, 256, 31, seed=args.seed)
    cfg = Stage2Config(**STAGE2, seed=args.seed, scan_epochs=0,
                       num_epoch=2)
    train_ktgnn(data, cfg, device="cuda")
    one = dataclasses.replace(cfg, num_epoch=1)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    train = attribute(profiled(lambda: train_ktgnn(data, one,
                                                   device="cuda"),
                               out_dir / "prologue_train_trace.json"), 1.0)

    model = build_model(cfg, 31, 256, "cuda")
    pred = KTGNNPredictor(model, None, data, to_undirected=True,
                          adjacency_method="auto", device="cuda",
                          matmul_precision="default")
    rng = np.random.default_rng(args.seed)

    def request():
        ids = rng.choice(131072, size=256, replace=False)
        rows = rng.normal(size=(256, 256)).astype(np.float32)
        pred.predict_live(x=rows, nodes=ids)

    for _ in range(3):
        request()

    def requests():
        for _ in range(args.requests):
            request()

    serve = attribute(profiled(requests,
                               out_dir / "prologue_serve_trace.json"),
                      1.0 / args.requests)
    out = dict(card=card, torch=torch.__version__, train_epoch=train,
               serve_request=serve)
    (out_dir / "prologue_profile.json").write_text(
        json.dumps(out, indent=1))
    for mode, r in (("train_epoch", train), ("serve_request", serve)):
        print(json.dumps(dict(
            mode=mode, card=card,
            **{k: round(v, 4) for k, v in r.items() if k != "rows"},
            top=[(x["key"][:150], round(x["ms"], 4), x["prologue"])
                 for x in r["rows"][:25]])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
