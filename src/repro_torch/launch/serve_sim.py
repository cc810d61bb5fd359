"""Epidemic simulation server CLI — the serving tier's front door (the
port of the reference's ``repro.launch.serve_sim``).

Two modes over one in-process :class:`repro_torch.serve.SimulationServer`
on ``--device`` (the card unless ``--device cpu`` is asked for):

**Load-generator mode** (default): warm the base spec's bucket (on the
card: capture its CUDA graph), fire a deterministic concurrent request mix
(seeds and replicate widths vary, the bucket does not), and print/emit the
server metrics, usable as a smoke test: ``--check`` exits non-zero on any
steady-state capture or failed request.

    PYTHONPATH=src python -m repro_torch.launch.serve_sim \
        --dataset twin-2k --days 10 --requests 8 --concurrency 2 \
        --chunk-days 2 --out serve_metrics.json --check --device cpu

**HTTP mode** (``--http PORT``): a minimal stdlib server exposing the
tier over a socket — ``POST /run`` with an ExperimentSpec JSON body
returns the RunResult JSON; ``GET /metrics`` returns server metrics.
No extra dependencies; single-process, for demos and local what-if UIs,
not production TLS/auth.

Both modes serve on one device. Serving on a mesh (``ServeConfig.layout``
``workers``, ``scenarios`` or ``hybrid``) is SPMD, so it is driven from a
function every rank runs, started by ``repro_torch.launch.mesh.spawn`` or
``torchrun``: each rank constructs the server, rank 0 serves and closes,
the others call ``SimulationServer.follow()`` (``serve/server.py``); this
CLI has no layout flag, as the reference's has none.

Not to be confused with :mod:`repro_torch.launch.serve`, the LM
token-serving CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.launch.cli import (
    add_common_args,
    build_spec,
    parse_intervention_axis,
)
from repro_torch.serve import ServeConfig, SimulationServer

DEFAULTS = dict(
    name="serve-sim", dataset="twin-2k", days=10,
    interventions=("none", "school-closure"),
)


def _int_csv(csv: str, flag: str) -> tuple:
    try:
        return tuple(int(s) for s in csv.split(","))
    except ValueError:
        raise SystemExit(f"error: {flag} must be comma-separated ints, "
                         f"got '{csv}'")


def make_config(args) -> ServeConfig:
    return ServeConfig(
        chunk_days=args.chunk_days,
        b_lattice=_int_csv(args.b_lattice, "--b-lattice"),
        seed_lattice=_int_csv(args.seed_lattice, "--seed-lattice"),
        max_executables=args.max_executables,
        max_wait_s=args.max_wait_ms / 1e3,
        strict=not args.no_strict,
    )


def load_generate(server: SimulationServer, base, requests: int,
                  concurrency: int) -> dict:
    """Closed-loop deterministic load: request i varies the Monte Carlo
    seed and alternates 1/2 replicates (two batch widths, one bucket
    family); `concurrency` clients each keep one request in flight."""
    mix = [base.with_overrides(seed=i + 1, replicates=1 + (i % 2))
           for i in range(requests)]
    tickets = [None] * len(mix)

    def client(worker: int):
        for i in range(worker, len(mix), concurrency):
            ticket = server.submit(mix[i])
            tickets[i] = ticket
            ticket.result(timeout=600)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        for f in [pool.submit(client, w) for w in range(concurrency)]:
            f.result()
    wall = time.perf_counter() - t0
    ttfds = sorted(t.ttfd_s for t in tickets if t.ttfd_s is not None)
    return {
        "requests": requests,
        "concurrency": concurrency,
        "wall_s": round(wall, 3),
        "specs_per_s": round(requests / wall, 3),
        "ttfd_p50_s": round(ttfds[len(ttfds) // 2], 5) if ttfds else None,
    }


def serve_http(server: SimulationServer, port: int):  # pragma: no cover - loop
    """Blocking stdlib HTTP front: POST /run (spec JSON -> result JSON),
    GET /metrics. Ctrl-C to stop."""
    httpd = make_http_server(server, port)
    host, bound = httpd.server_address[:2]
    print(f"serving on http://{host}:{bound}  "
          f"(POST /run, GET /metrics; Ctrl-C stops)", flush=True)
    server.start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


def make_http_server(server: SimulationServer, port: int):
    """Build (not run) the stdlib HTTP server — split out so tests can
    bind port 0 and drive it from a thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch.api.spec import ExperimentSpec

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                self._send(200, server.metrics_dict())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path.rstrip("/") != "/run":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                spec = ExperimentSpec.from_json(self.rfile.read(n).decode())
                result = server.run(spec, timeout=600)
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - surface as 500
                self._send(500, {"error": str(e)})
                return
            self._send(200, result.to_dict())

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="epidemic scenario server: warm-cache load generator "
                    "or stdlib HTTP front (see repro_torch.serve)")
    add_common_args(ap)
    ap.add_argument("--interventions", default=None,
                    help="comma list of intervention presets (the bucket's "
                         "slot structure)")
    # serving knobs
    ap.add_argument("--chunk-days", type=int, default=2,
                    help="days per streamed chunk = the one captured "
                         "day-count per bucket")
    ap.add_argument("--b-lattice", default="2,4,8",
                    help="scenario-width bucket lattice (comma ints)")
    ap.add_argument("--seed-lattice", default="16,64,256",
                    help="seed_per_day cap lattice (comma ints)")
    ap.add_argument("--max-executables", type=int, default=4,
                    help="warm bucket budget (LRU beyond it)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="batching window before a partial dispatch")
    ap.add_argument("--no-strict", action="store_true",
                    help="count steady-state captures instead of failing "
                         "the batch")
    # load generator / http
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead of running the load "
                         "generator")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on recompile violations (steady-state "
                         "captures) or failed requests")
    args = ap.parse_args(argv)

    extra = {}
    if args.interventions:
        extra["interventions"] = parse_intervention_axis(args.interventions)
    base = build_spec(args, DEFAULTS, **extra)
    try:
        server = SimulationServer(make_config(args), device=args.device)
    except (RuntimeError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}")

    if args.http is not None:
        serve_http(server, args.http)
        return

    warm = server.warm_up(base)
    print(f"# warmed {warm['bucket']} in {warm['compile_s']:.2f}s",
          flush=True)
    with server:  # background dispatch thread for the duration of the load
        load = load_generate(server, base, args.requests, args.concurrency)
    metrics = server.metrics_dict()
    report = {"driver": "serve_sim", "spec": base.to_dict(),
              "load": load, "metrics": metrics}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"load": load,
                      "executables": metrics["executables"],
                      "requests": metrics["requests"]}, indent=1))
    if args.check:
        ex = metrics["executables"]
        bad = []
        if ex["recompile_violations"]:
            bad.append(f"{ex['recompile_violations']} recompile violations")
        if metrics["requests"]["failed"]:
            bad.append(f"{metrics['requests']['failed']} failed requests")
        if metrics["requests"]["completed"] < args.requests:
            bad.append("incomplete")
        if bad:
            print(f"# serve_sim check FAILED: {', '.join(bad)}",
                  file=sys.stderr)
            raise SystemExit(1)
        print("# serve_sim check OK: zero steady-state recompiles "
              "(captures)", flush=True)


if __name__ == "__main__":
    main()
