"""HTTP serving for a compiled likelihood engine.

Production-deployment surface (no reference counterpart): load the engine
once (topology compiled, alignment resident on device), then serve
logL / sitewise / gradient / fit requests over JSON. Stdlib-only
(ThreadingHTTPServer); device dispatch is serialized per request by the
Python-side dispatch, which is the right behavior for a single-chip
replica — scale-out is one server per chip behind any standard LB.

Endpoints
---------
GET  /health            -> engine + device info
POST /loglik            {"params": {...}?}         -> {"loglik": x}
POST /sitewise          {"params": {...}?}         -> {"sitewise": [...]}
POST /gradient          {"params": {...}?}         -> {"gradient": {...}}
POST /fit               {"params": ..., "max_steps": n, "free": [...]}
POST /bootstrap         {"n": 100, "seed": 0}      -> {"logliks": [...]}
POST /partitions        {"params": {...}?}         -> {"partitions": {...}}
POST /ancestral         {"params": ...?, "joint": bool} -> MAP/joint states
POST /site_rates        {"params": {...}?}         -> posterior-mean rates
                        (PartitionedEngine only; engines that lack an
                        endpoint's method return a clean 501)
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["EngineServer", "serve"]


def _tree_to_json(tree):
    import jax

    return jax.tree.map(lambda x: np.asarray(x).tolist(), tree)


class EngineServer:
    """Wraps a LikelihoodEngine (or PartitionedEngine) behind HTTP."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080):
        self.engine = engine
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- request handlers ----------------------------------------------------

    def _handle(self, route: str, body: dict) -> dict:
        import jax

        engine = self.engine
        params = body.get("params")
        with self._lock:  # one device dispatch at a time
            if route == "/health":
                model = getattr(engine, "model", None)
                if model is not None:
                    model_name = model.name
                else:  # PartitionedEngine: report per-partition models
                    model_name = {
                        p.name: p.model.name
                        for p in getattr(engine, "partitions", [])
                    }
                dev = jax.devices()[0]
                return {
                    "status": "ok",
                    "device": str(dev),
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                    "model": model_name,
                    "n_patterns": int(np.asarray(engine._weights).shape[0])
                    if not isinstance(engine._weights, tuple)
                    else sum(int(np.asarray(w).shape[0])
                             for w in engine._weights),
                }
            if route == "/loglik":
                return {"loglik": engine.loglikelihood(params)}
            if route == "/sitewise":
                if not hasattr(engine, "sitewise_loglikelihoods"):
                    raise NotImplementedError(
                        "sitewise is not supported by "
                        f"{type(engine).__name__}; use /partitions"
                    )
                return {
                    "sitewise": engine.sitewise_loglikelihoods(params).tolist()
                }
            if route == "/partitions":
                if not hasattr(engine, "partition_loglikelihoods"):
                    raise NotImplementedError(
                        "per-partition logL requires a PartitionedEngine"
                    )
                return {
                    "partitions": {
                        k: float(v)
                        for k, v in engine.partition_loglikelihoods(
                            params
                        ).items()
                    }
                }
            if route == "/gradient":
                return {"gradient": _tree_to_json(engine.gradient(params))}
            if route == "/ancestral":
                from phylo_utils_tpu.ancestral import (
                    ancestral_posteriors,
                    joint_ancestral_states,
                )

                if body.get("joint"):
                    joint = joint_ancestral_states(engine, params)
                    return {
                        "states": joint["states"].tolist(),
                        "log_prob": joint["log_prob"].tolist(),
                        "category": joint["category"].tolist(),
                    }
                post = ancestral_posteriors(engine, params)
                return {
                    "map_states": post.argmax(axis=2).tolist(),
                    "max_posterior": post.max(axis=2).tolist(),
                }
            if route == "/site_rates":
                from phylo_utils_tpu.ancestral import site_rates

                return {"site_rates": site_rates(engine, params).tolist()}
            if route == "/bootstrap":
                if not hasattr(engine, "bootstrap_loglikelihoods"):
                    raise NotImplementedError(
                        "bootstrap is not supported by "
                        f"{type(engine).__name__}"
                    )
                boots = engine.bootstrap_loglikelihoods(
                    int(body.get("n", 100)), params,
                    seed=int(body.get("seed", 0)),
                )
                return {"logliks": boots.tolist()}
            if route == "/fit":
                from phylo_utils_tpu.optimize import fit

                res = fit(
                    engine,
                    params,
                    free=tuple(body["free"]) if body.get("free") else None,
                    max_steps=int(body.get("max_steps", 200)),
                    steps_per_call=int(body.get("steps_per_call", 1)),
                )
                return {
                    "loglik": res.loglik,
                    "n_steps": res.n_steps,
                    "converged": res.converged,
                    "params": _tree_to_json(res.params),
                }
        raise KeyError(route)

    # -- server lifecycle ----------------------------------------------------

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, route: str, body: dict):
                try:
                    self._reply(200, outer._handle(route, body))
                except KeyError:
                    self._reply(404, {"error": f"unknown route {route}"})
                except NotImplementedError as exc:
                    self._reply(501, {"error": str(exc)})
                except Exception as exc:  # surface as a clean 400
                    self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})

            def do_GET(self):
                if self.path == "/health":
                    self._dispatch("/health", {})
                else:
                    self._reply(404, {"error": f"unknown route {self.path}"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except Exception as exc:
                    self._reply(400, {"error": f"bad JSON body: {exc}"})
                    return
                self._dispatch(self.path, body)

        return Handler

    def start(self) -> int:
        """Start serving in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def serve_forever(self):
        self.start()
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()


def serve(engine, host: str = "127.0.0.1", port: int = 8080) -> None:
    """Blocking convenience wrapper (used by the CLI)."""
    srv = EngineServer(engine, host, port)
    print(json.dumps({"serving": f"http://{host}:{srv.start()}"}), flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
