"""HTTP serving entry point (predictor mode).

Port of ``bridged_gnn_tpu/cli/serve.py``'s predictor mode: full-graph
node classification over a bridged graph with any stage-2 model
(``--model_name``, ``--no_dtc`` as the JAX flags: ``--no_dtc`` with the
default KTGNN serves ``KTGNNNoDTC``), behind a JSON-over-HTTP
API (stdlib ``http.server``). Predictions over the loaded graph are cached
at startup; requests carrying feature updates run the model live, and
``/v1/refresh`` installs new features persistently and rebuilds the
cache. ``--mode similarity`` is not ported yet (ROADMAP.md Queue 1
item 7).

Endpoints:
  GET  /healthz            -> {"status": "ok", "backend": "cuda"|"cpu"}
  GET  /meta               -> model/graph metadata
  POST /v1/predict         {"head": "target_hat", "nodes": [0, 3, ...]?,
                            "x": [[...]]?, "x_nodes": [...]?,
                            "log_probs": false}
  POST /v1/refresh         {"x": [[...]], "nodes": [...]?}

Run: ``python -m bridged_gnn_tpu_torch.cli.serve --mode predictor
--ckpt best.pkl --path_data graph.npz [--model_name GraphSAGE]
[--device cuda]``, where the checkpoint is a stage-2 CLI's ``--save``
pickle (either package's) of that model.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


# the predictor's heads (a single-output model's one head under each name)
HEADS = ("source", "target", "target_hat")


class ServingApp:
    """Holds the loaded predictor and answers API calls."""

    def __init__(self, predictor, meta: Optional[Dict[str, Any]] = None,
                 verbose: bool = False,
                 max_request_bytes: int = 64 * 1024 * 1024):
        if predictor is None:
            raise ValueError("need a predictor")
        self.predictor = predictor
        self.meta = dict(meta or {})
        self.verbose = verbose  # request logging in the HTTP handler
        self.max_request_bytes = int(max_request_bytes)
        # serialize device work: one request computes at a time
        self._lock = threading.Lock()
        # graph + weights are fixed -> predictions are, too
        self._predictions = predictor.predict()
        self._backend = predictor.device.type

    def healthz(self) -> Dict[str, Any]:
        return {"status": "ok", "backend": self._backend}

    def predict(self, body: Dict[str, Any]) -> Dict[str, Any]:
        head = body.get("head", "target_hat")
        if head not in HEADS:
            raise _ApiError(
                400, f"unknown head {head!r}; one of {sorted(HEADS)}")
        x = body.get("x")
        if x is not None:
            # live inference on updated features for this request only:
            # "x" is the full [N, D] feature matrix, or rows of "x_nodes"
            preds = self._run_live(x, body.get("x_nodes"))
            computed = "live"
        else:
            # under the lock: a refresh installs features and rebuilds
            # the cache as one step
            with self._lock:
                preds = self._predictions
            computed = "cache"
        lp = preds[head]
        nodes = body.get("nodes")
        if nodes is not None:
            nodes = np.asarray(nodes, dtype=np.int64)
            if nodes.ndim != 1 or (nodes < 0).any() or (
                    nodes >= lp.shape[0]).any():
                raise _ApiError(
                    400, f"'nodes' must be ids in [0, {lp.shape[0]})")
            lp = lp[nodes]
        out: Dict[str, Any] = {"labels": lp.argmax(1).tolist(),
                               "computed": computed}
        if body.get("log_probs"):
            out["log_probs"] = lp.tolist()
        return out

    def _run_live(self, x, x_nodes=None) -> Dict[str, Any]:
        try:
            x = np.asarray(x, dtype=np.float32)
            # no dtype coercion: the predictor validates integer ids
            nodes = None if x_nodes is None else np.asarray(x_nodes)
        except (TypeError, ValueError) as e:
            raise _ApiError(400, f"bad feature payload: {e}")
        with self._lock:
            try:
                return self.predictor.predict_live(x, nodes)
            except ValueError as e:
                raise _ApiError(400, str(e))

    def refresh(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Persistently install new features and rebuild the prediction
        cache — POST /v1/refresh {"x": [[...]], "nodes": [...]?}."""
        x = body.get("x")
        if x is None:
            raise _ApiError(400, "'x' (feature rows) is required")
        try:
            x = np.asarray(x, dtype=np.float32)
            nodes = body.get("nodes")
            nodes = None if nodes is None else np.asarray(nodes)
        except (TypeError, ValueError) as e:
            raise _ApiError(400, f"bad feature payload: {e}")
        with self._lock:
            try:
                self.predictor.update_features(x, nodes)
            except ValueError as e:
                raise _ApiError(400, str(e))
            self._predictions = self.predictor.predict()
        return {"status": "ok",
                "updated_rows": int(len(nodes) if nodes is not None
                                    else x.shape[0])}


class _ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class _Handler(BaseHTTPRequestHandler):
    server_version = "bridged-gnn-tpu-torch-serve/1.0"
    app: ServingApp = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.app, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, obj: Dict[str, Any]):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/healthz":
            return self._send(200, self.app.healthz())
        if self.path == "/meta":
            return self._send(200, self.app.meta)
        return self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > self.app.max_request_bytes:
                raise _ApiError(
                    413, f"request body of {length} bytes exceeds the "
                         f"{self.app.max_request_bytes} byte limit")
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/v1/predict":
                return self._send(200, self.app.predict(body))
            if self.path == "/v1/refresh":
                return self._send(200, self.app.refresh(body))
            return self._send(404, {"error": f"unknown path {self.path}"})
        except _ApiError as e:
            return self._send(e.code, {"error": e.message})
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            return self._send(400, {"error": str(e)})
        except Exception:  # model/device errors -> JSON 500, logged here
            import traceback

            traceback.print_exc(file=sys.stderr)
            return self._send(500, {"error": "internal error"})


def make_server(app: ServingApp, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 = ephemeral."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


# ---------------------------------------------------------------- loading


def _load_predictor(args) -> ServingApp:
    from bridged_gnn_tpu_torch.io.flax_weights import state_dict_from_flax
    from bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer import (
        load_bridged_graph,
    )
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train.stage2 import (
        Stage2Config,
        build_model,
        built_model_name,
    )

    data = load_bridged_graph(args.path_data)
    # the checkpoint is a pickle this project's stage-2 CLI wrote; load
    # only files you trust
    with open(args.ckpt, "rb") as f:
        variables = pickle.load(f)
    if not isinstance(variables, dict) or "params" not in variables:
        raise SystemExit(
            f"{args.ckpt} is not a stage-2 checkpoint (expected a pickled "
            "dict with 'params'/'batch_stats' — the stage-2 CLI's --save "
            "artifact)")
    cfg = Stage2Config(
        model_name=args.model_name, num_layer=args.num_layer,
        hidden=args.hidden_dim, no_dtc=args.no_dtc,
        to_undirected=args.to_undirected,
    )
    num_classes = int(np.asarray(data["y"]).max()) + 1
    model = build_model(cfg, num_classes, int(data["x"].shape[1]),
                        device="cpu")
    predictor = KTGNNPredictor(
        model, state_dict_from_flax(model, variables), data,
        to_undirected=cfg.to_undirected, device=args.device,
        matmul_precision=args.matmul_precision,
    )
    meta = dict(
        mode="predictor", model_name=built_model_name(cfg),
        num_nodes=int(data["x"].shape[0]),
        num_classes=num_classes,
        heads=list(HEADS),
        matmul_precision=args.matmul_precision,
        device=str(predictor.device),
    )
    return ServingApp(predictor=predictor, meta=meta, verbose=args.verbose,
                      max_request_bytes=args.max_request_bytes)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve a trained stage-2 model over HTTP "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--mode", choices=["predictor", "similarity"],
                    required=True)
    ap.add_argument("--ckpt", required=True,
                    help="stage-2 --save pickle of the JAX package")
    ap.add_argument("--path_data", help="bridged graph .npz or .dat")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8808)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve from (default: cuda)")
    # model hyperparams (must match training)
    ap.add_argument("--model_name", default="KTGNN")
    ap.add_argument("--num_layer", type=int, default=2)
    ap.add_argument("--hidden_dim", type=int, default=64)
    # with the default KTGNN: KTGNNNoDTC (not the training CLI's GraphSAGE)
    ap.add_argument("--no_dtc", action="store_true", default=False)
    ap.add_argument("--to_undirected", action="store_true", default=False)
    # JAX's precision names: "default" and "bfloat16" run the card's f32
    # matmuls in TF32
    ap.add_argument("--matmul_precision", default=None,
                    choices=["highest", "float32", "default", "bfloat16"])
    ap.add_argument("--verbose", action="store_true", default=False,
                    help="log each HTTP request")
    ap.add_argument("--max_request_bytes", type=int,
                    default=64 * 1024 * 1024,
                    help="reject POST bodies larger than this (413)")
    return ap


def main(args) -> None:
    if args.mode != "predictor":
        raise NotImplementedError(
            "--mode similarity is not ported yet; see ROADMAP.md Queue 1 "
            "item 7 (serve it with python -m bridged_gnn_tpu.cli.serve)")
    if not args.path_data:
        raise SystemExit("--mode predictor needs --path_data")
    app = _load_predictor(args)
    srv = make_server(app, args.host, args.port)
    host, port = srv.server_address[:2]
    print(f"serving predictor on http://{host}:{port} "
          f"(endpoints: /healthz /meta /v1/predict /v1/refresh)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()


def cli_entry():
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli_entry()
