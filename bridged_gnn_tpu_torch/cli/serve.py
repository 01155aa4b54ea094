"""HTTP serving entry point.

Port of ``bridged_gnn_tpu/cli/serve.py``: the two trained artifacts
behind a JSON-over-HTTP API (stdlib ``http.server``).

  * ``--mode predictor``: full-graph node classification over a bridged
    graph with any stage-2 model (``--model_name``, ``--no_dtc`` as the
    JAX flags: ``--no_dtc`` with the default KTGNN serves
    ``KTGNNNoDTC``). Predictions over the loaded graph are cached at
    startup; requests carrying feature updates run the model live, and
    ``/v1/refresh`` installs new features persistently and rebuilds the
    cache.
  * ``--mode similarity``: the top-k most similar source nodes of query
    rows against a fixed source corpus (``serve.SimilarityScorer``), from
    a stage-1 checkpoint: the stage-1 CLI's ``--save`` pickle (either
    package's) or a reference AdvLearner ``.ckpt`` state dict.

Endpoints:
  GET  /healthz            -> {"status": "ok", "backend": "cuda"|"cpu"}
  GET  /meta               -> model/graph metadata ("mode")
  POST /v1/topk            {"x": [[...]], "k": 5}          (similarity)
  POST /v1/predict         {"head": "target_hat", "nodes": [0, 3, ...]?,
                            "x": [[...]]?, "x_nodes": [...]?,
                            "log_probs": false}            (predictor)
  POST /v1/refresh         {"x": [[...]], "nodes": [...]?}  (predictor)

Run: ``python -m bridged_gnn_tpu_torch.cli.serve --mode predictor
--ckpt best.pkl --path_data graph.npz [--model_name GraphSAGE]
[--device cuda]``, where the checkpoint is a stage-2 CLI's ``--save``
pickle (either package's) of that model; or ``--mode similarity --ckpt
model_AdvLearner_<dataset>_best.pkl --corpus graph.npz [--sim_mode mlp]
[--backbone mlp] [--hidden_dim 64]``, where a merged bridged graph's
source domain is the corpus.
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
    """Holds the loaded scorer or predictor and answers API calls."""

    def __init__(self, scorer=None, predictor=None,
                 meta: Optional[Dict[str, Any]] = None,
                 verbose: bool = False,
                 max_request_bytes: int = 64 * 1024 * 1024,
                 max_query_rows: int = 4096):
        if scorer is None and predictor is None:
            raise ValueError("need at least one of scorer/predictor")
        self.scorer = scorer
        self.predictor = predictor
        self.meta = dict(meta or {})
        self.verbose = verbose  # request logging in the HTTP handler
        # request-size guards: one oversized POST must not exhaust the
        # process's memory or the card's
        self.max_request_bytes = int(max_request_bytes)
        self.max_query_rows = int(max_query_rows)
        # serialize device work: one request computes at a time
        self._lock = threading.Lock()
        self._predictions = None
        if predictor is not None:
            # graph + weights are fixed -> predictions are, too
            self._predictions = predictor.predict()
        self._backend = (predictor or scorer).device.type

    def healthz(self) -> Dict[str, Any]:
        return {"status": "ok", "backend": self._backend}

    def topk(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """The top-k source ids and scores of each query row — POST
        /v1/topk {"x": [[...]], "k": 5}. 400 for a payload that is no 2-D
        array of the model's query width or a ``k`` outside [1, number
        of sources], 413 for more than ``max_query_rows`` rows."""
        if self.scorer is None:
            raise _ApiError(404, "no similarity scorer loaded")
        x = np.asarray(body.get("x"), dtype=np.float32)
        if x.ndim != 2:
            raise _ApiError(400, "'x' must be a 2-D array of query rows")
        if x.shape[0] > self.max_query_rows:
            raise _ApiError(
                413, f"at most {self.max_query_rows} query rows per "
                     f"request, got {x.shape[0]}")
        if x.shape[1] != self.scorer.dim_in_tar:
            raise _ApiError(
                400, f"'x' rows must have dim {self.scorer.dim_in_tar}, "
                     f"got {x.shape[1]}")
        k = int(body.get("k", 5))
        if not 1 <= k <= self.scorer.num_src:
            raise _ApiError(400,
                            f"'k' must be in [1, {self.scorer.num_src}]")
        with self._lock:
            vals, idxs = self.scorer.topk_sources(x, k)
        return {"values": vals.tolist(), "indices": idxs.tolist()}

    def predict(self, body: Dict[str, Any]) -> Dict[str, Any]:
        if self.predictor is None:
            raise _ApiError(404, "no predictor loaded")
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
        if self.predictor is None:
            raise _ApiError(404, "no predictor loaded")
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
            if self.path == "/v1/topk":
                return self._send(200, self.app.topk(body))
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
                      max_request_bytes=args.max_request_bytes,
                      max_query_rows=args.max_query_rows)


def _is_torch_state_dict(obj) -> bool:
    """A reference ``state_dict`` (dotted names), not a flax-layout
    pickle (``params``/``batch_stats``)."""
    return isinstance(obj, dict) and bool(obj) and all(
        isinstance(k, str) for k in obj) and any(
        "." in k for k in obj) and "params" not in obj


def _load_scorer(args) -> ServingApp:
    """The similarity app of JAX ``cli/serve.py:303-360``: the corpus
    (``.npz`` or ``.dat``; a merged bridged graph is split by
    ``dataset_conversion`` and its source domain kept), a model of the
    flags' shape, and its weights from a reference torch ``.ckpt`` or
    this project's stage-1 ``--save`` pickle."""
    from bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer import (
        load_bridged_graph,
    )
    from bridged_gnn_tpu_torch.graph import graph_from_dict
    from bridged_gnn_tpu_torch.io.ckpt_import import (
        load_reference_state_dict,
    )
    from bridged_gnn_tpu_torch.io.flax_weights import state_dict_from_flax
    from bridged_gnn_tpu_torch.io.pyg_compat import load_torch_state_dict
    from bridged_gnn_tpu_torch.nn.stage1 import AdversarialLearnerV2
    from bridged_gnn_tpu_torch.serve import SimilarityScorer

    corpus = load_bridged_graph(args.corpus)
    if "central_mask" in corpus and not np.asarray(
            corpus["central_mask"]).all():
        # a merged graph: the source corpus is its central domain
        from bridged_gnn_tpu_torch.data.datasets import dataset_conversion

        corpus = dataset_conversion(dict(corpus), seed=0)[0]
    # the checkpoint is a pickle of this project's or the reference's;
    # load only files you trust
    try:
        sd = load_torch_state_dict(args.ckpt)
    except Exception as torch_err:
        try:
            with open(args.ckpt, "rb") as f:
                sd = pickle.load(f)
        except Exception as pickle_err:
            raise SystemExit(
                f"{args.ckpt} loads neither as a torch state_dict "
                f"({type(torch_err).__name__}: {torch_err}) nor as a "
                f"stage-1 pickle ({type(pickle_err).__name__}: "
                f"{pickle_err})")
    d_in = int(corpus["x"].shape[1])
    n_cls = int(np.asarray(corpus["y"]).max()) + 1
    model = AdversarialLearnerV2(
        dim_in_src=d_in, dim_in_tar=args.dim_tar or d_in,
        num_classes_src=n_cls, num_classes_tar=n_cls,
        dim_hidden=args.hidden_dim, source_clf=True, use_norm=True,
        norm_mode=args.norm_mode, backbone=args.backbone,
        sim_mode=args.sim_mode, num_layer=args.num_layer)
    state_dict = (load_reference_state_dict(model, sd)
                  if _is_torch_state_dict(sd)
                  else state_dict_from_flax(model, sd))
    scorer = SimilarityScorer(
        model, state_dict, graph_from_dict(dict(corpus)),
        sim_mode=args.sim_mode, row_block=args.row_block,
        approx_recall=args.topk_recall, device=args.device)
    meta = dict(
        mode="similarity", num_src=int(scorer.num_src), dim_in=d_in,
        dim_query=int(scorer.dim_in_tar), sim_mode=args.sim_mode,
        backbone=args.backbone, device=str(scorer.device))
    return ServingApp(scorer=scorer, meta=meta, verbose=args.verbose,
                      max_request_bytes=args.max_request_bytes,
                      max_query_rows=args.max_query_rows)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve a trained stage-2 model over HTTP "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--mode", choices=["predictor", "similarity"],
                    required=True)
    ap.add_argument("--ckpt", required=True,
                    help="stage-2 --save pickle (predictor) | stage-1 "
                         "--save pickle or reference AdvLearner .ckpt "
                         "(similarity)")
    ap.add_argument("--path_data", help="bridged graph .npz or .dat "
                                        "(predictor mode)")
    ap.add_argument("--corpus", help="source-corpus graph .npz or .dat "
                                     "(similarity mode)")
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
    # similarity model hyperparams (must match training)
    ap.add_argument("--sim_mode", default="mlp", choices=["mlp", "cosine"])
    ap.add_argument("--backbone", default="mlp", choices=["mlp", "gnn"])
    ap.add_argument("--norm_mode", default="None")
    ap.add_argument("--dim_tar", type=int, default=0,
                    help="target-domain feature dim if != corpus dim")
    ap.add_argument("--row_block", type=int, default=256)
    # None = exact top-k; a recall target in (0, 1] is accepted and
    # selects exactly, as the bridge's --topk_recall
    ap.add_argument("--topk_recall", type=float, default=None)
    ap.add_argument("--verbose", action="store_true", default=False,
                    help="log each HTTP request")
    ap.add_argument("--max_request_bytes", type=int,
                    default=64 * 1024 * 1024,
                    help="reject POST bodies larger than this (413)")
    ap.add_argument("--max_query_rows", type=int, default=4096,
                    help="max query rows per /v1/topk request (413)")
    return ap


def main(args) -> None:
    if args.mode == "predictor":
        if not args.path_data:
            raise SystemExit("--mode predictor needs --path_data")
        app = _load_predictor(args)
        endpoints = "/healthz /meta /v1/predict /v1/refresh"
    else:
        if not args.corpus:
            raise SystemExit("--mode similarity needs --corpus")
        app = _load_scorer(args)
        endpoints = "/healthz /meta /v1/topk"
    srv = make_server(app, args.host, args.port)
    host, port = srv.server_address[:2]
    print(f"serving {args.mode} on http://{host}:{port} "
          f"(endpoints: {endpoints})")
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
