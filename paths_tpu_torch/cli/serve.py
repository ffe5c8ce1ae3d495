"""HTTP inference server over a trained model (counterpart of
`paths_tpu.cli.serve`):

    python -m paths_tpu_torch.cli.serve -m models/DIR [--artifact FILE] \
        [--store DIR] [--host 127.0.0.1] [--port 8000] [--batch-size N] \
        [--device cuda] [--data-parallel N]

Routes (JSON in and out):
    GET  /healthz   -> {"ok": true, ...session info}
    GET  /slides    -> {"slide_ids": [...]} slides present in the store
    GET  /metrics   -> request and error counters, prediction seconds
    POST /predict   <- {"slide_ids": [...]}
                    -> {"predictions": [{"slide_id", "risk", "hazards"} |
                                        {"slide_id", "pred", "probs"}]}

Requests are threads of a `ThreadingHTTPServer`; the session runs one batch
on the device at a time. With `--artifact` the session runs a `cli.export`
artifact at its export-time shapes, and a request for slides beyond them is
a client error (400). `--data-parallel N` serves the live model over the
host's first N cards (`ServingSession(mesh=...)`), or N shards on one
named `--device`.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_server(session, host: str = "127.0.0.1", port: int = 0):
    """A `ThreadingHTTPServer` bound to (host, port) serving `session`.
    Call `.serve_forever()` (or `.handle_request()` for one request);
    `.server_address` reports the bound port when 0 was requested."""

    stats = {"requests": 0, "errors": 0, "slides_predicted": 0,
             "predict_seconds_total": 0.0}
    stats_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # quiet by default
            if server.verbose:
                sys.stderr.write("%s - %s\n" % (self.address_string(),
                                                fmt % args))

        def _count(self, error: bool = False, slides: int = 0,
                   seconds: float = 0.0) -> None:
            with stats_lock:
                stats["requests"] += 1
                stats["errors"] += error
                stats["slides_predicted"] += slides
                stats["predict_seconds_total"] += seconds

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, **session.info()})
            elif self.path == "/slides":
                self._send(200, {"slide_ids": session.slide_ids})
            elif self.path == "/metrics":
                with stats_lock:
                    self._send(200, dict(stats))
            else:
                self._send(404, {"error": f"no route {self.path}"})
            if self.path != "/metrics":
                self._count()

        def do_POST(self):
            if self.path != "/predict":
                self._count(error=True)
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                ids = req.get("slide_ids")
                if not (isinstance(ids, list) and ids
                        and all(isinstance(s, str) for s in ids)):
                    raise ValueError(
                        "slide_ids must be a non-empty list of strings")
            except ValueError as e:
                self._count(error=True)
                self._send(400, {"error": f"bad request: {e}"})
                return
            t0 = time.perf_counter()
            try:
                rows = session.predict(ids)
            except KeyError as e:
                self._count(error=True)
                self._send(404, {"error": str(e)})
                return
            except ValueError as e:   # e.g. slides beyond an artifact's shapes
                self._count(error=True)
                self._send(400, {"error": str(e)})
                return
            except Exception as e:   # device errors surface as 500
                self._count(error=True)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._count(slides=len(rows),
                        seconds=time.perf_counter() - t0)
            self._send(200, {"predictions": rows})

    server = ThreadingHTTPServer((host, port), Handler)
    server.verbose = False
    return server


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True)
    parser.add_argument("--artifact", default=None,
                        help="serve a cli.export artifact instead of the "
                             "live model")
    parser.add_argument("--store", default=None,
                        help="feature-store root (default: the config's "
                             "preprocess_dir)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--no-cache-slides", action="store_true",
                        help="rebuild slide tables per request (lower RAM)")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="serve data-parallel over this many cards (live "
                             "model only; 0 = one device); with a named "
                             "--device, that many shards on it")
    parser.add_argument("--cache-batches", type=int, default=4,
                        help="device-resident LRU of collated batches "
                             "(repeat requests skip collation and the copy "
                             "to the card); 0 disables")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: cuda)")
    args = parser.parse_args(argv)

    from paths_tpu_torch.parallel.mesh import device_mesh
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train.loop import set_matmul_precision

    mesh = (device_mesh(args.data_parallel, args.device)
            if args.data_parallel else None)
    session = ServingSession(args.model_dir, store_root=args.store,
                             batch_size=args.batch_size,
                             cache_slides=not args.no_cache_slides,
                             cache_batches=args.cache_batches,
                             device=args.device, artifact=args.artifact,
                             mesh=mesh)
    set_matmul_precision(session.config.compute_dtype)

    server = make_server(session, args.host, args.port)
    server.verbose = True
    host, port = server.server_address[:2]
    print(f"Serving {session.info()['backend']} on http://{host}:{port} "
          f"({len(session.slide_ids)} slides in store)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
