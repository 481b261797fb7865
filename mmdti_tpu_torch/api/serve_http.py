"""HTTP front and CLI for MolServe (port of mmdti_tpu/api/serve_http.py).

A stdlib ThreadingHTTPServer exposing the serving endpoints:

POST /predict  {"smiles": ["CCO", ...]}  ->
    {"predict": [[...]], "proba": [[...]]|null, "target_cols": [...],
     "valid": [...]}
POST /embed    {"smiles": [...]} -> {"cls_repr": ..., "pooled": ...}
GET  /health   -> status, artifact metadata, latency and batcher stats

Request bodies are JSON, capped at 32 MB (413 beyond); a body without a
SMILES list gets 400; a featurizer failure fails only the offending
request (DynamicBatcher retries co-batched riders alone); an overloaded
batcher answers 429 so clients back off.

    python -m mmdti_tpu_torch.api.serve_http <model_dir> [--host H] [--port P]
        [--warmup 1 8 ...] [--batch-window-ms MS] [--serve-folds 1|K|all]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from mmdti_tpu_torch.api.serve_batcher import DynamicBatcher, OverloadedError

logger = logging.getLogger("mmdti_tpu_torch")

MAX_BODY = 32 << 20  # a 32 MB JSON body holds 100k+ SMILES; larger ones are refused


def make_server(serve, host: str = "127.0.0.1", port: int = 8000,
                dynamic_batch_window_ms: float = 0.0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP front over a MolServe instance.
    ``dynamic_batch_window_ms`` > 0 puts a DynamicBatcher in front of
    /predict (the server's ``batcher``)."""
    batcher = (
        DynamicBatcher(serve, window_ms=dynamic_batch_window_ms)
        if dynamic_batch_window_ms > 0
        else None
    )

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path.rstrip("/") in ("", "/health"):
                    body = {
                        "status": "ok",
                        "task": serve.task,
                        "target_cols": serve.target_cols,
                        "compiled_shapes": serve.compiled_shapes,
                        "feature_cache_hits": serve.cache_hits,
                        "serve_folds": serve.serve_folds,
                        "mesh": (dict(serve.mesh.shape) if serve.mesh is not None
                                 else None),
                        "device": str(serve.device),
                        "latency": serve.latency_stats(),
                    }
                    if batcher is not None:
                        body["batcher"] = {
                            "batches_run": batcher.batches_run,
                            "requests_served": batcher.requests_served,
                            "pending": batcher._q.qsize(),
                        }
                    self._reply(200, body)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # the liveness probe must answer
                logger.exception("health request failed")
                self._reply(500, {"error": str(e)})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY:
                    self._reply(413, {
                        "error": f"request body {length} bytes exceeds "
                        f"the {MAX_BODY} byte limit",
                    })
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError as e:
                    self._reply(400, {"error": f"body is not JSON: {e}"})
                    return
                smiles = req.get("smiles") if isinstance(req, dict) else None
                if not smiles or not isinstance(smiles, list):
                    self._reply(400, {"error": "body must be {'smiles': [...]}"})
                    return
                if self.path.rstrip("/") == "/predict":
                    try:
                        out = batcher.submit(smiles) if batcher else serve.predict(smiles)
                    except OverloadedError as e:
                        self._reply(429, {"error": str(e)})
                        return
                    self._reply(200, {
                        "predict": np.asarray(out["predict"]).tolist(),
                        "proba": None if out["proba"] is None
                        else np.asarray(out["proba"]).tolist(),
                        "target_cols": out["target_cols"],
                        "valid": np.asarray(out["valid"]).tolist(),
                    })
                elif self.path.rstrip("/") == "/embed":
                    cls_r, pooled = serve.embed(smiles)
                    self._reply(200, {"cls_repr": cls_r.tolist(), "pooled": pooled.tolist()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # serving must not die on one bad request
                logger.exception("request failed")
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 drops the connections
        # of a burst of clients, which retry a second later
        request_queue_size = 128

        def server_close(self):  # stop the batcher's threads with the server
            if batcher is not None:
                batcher.stop()
            super().server_close()

    server = _Server((host, port), Handler)
    server.batcher = batcher
    return server


def main(argv: Optional[List[str]] = None):
    import argparse

    from mmdti_tpu_torch.api.serve_api import MolServe

    ap = argparse.ArgumentParser(description="Serve a trained MM-DTI experiment over HTTP")
    ap.add_argument("model_dir", help="experiment dir written by MolTrain.fit")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--warmup", type=int, nargs="*", default=[1],
                    help="batch sizes whose buckets are recorded at start (default: 1)")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent requests for this many ms (0 = off)")
    ap.add_argument("--serve-folds", default="1",
                    help="1 (fold 0, default), K, or 'all': serve a CV experiment's "
                    "folds as an ensemble")
    ap.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                    help="serve over a (data, model) device mesh: DATA replicas of MODEL "
                    "tensor-parallel shards, one shard a card, each replica taking an equal "
                    "share of a batch's rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    folds = args.serve_folds if args.serve_folds == "all" else int(args.serve_folds)
    srv = MolServe(args.model_dir, serve_folds=folds, mesh_shape=args.mesh,
                   device=args.device)
    if args.warmup:
        srv.warmup(args.warmup)
    srv.serve(args.host, args.port, dynamic_batch_window_ms=args.batch_window_ms)


if __name__ == "__main__":
    main()
