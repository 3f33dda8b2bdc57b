"""REST model server with the reference's endpoint contract.

The port of ``ldm3d_tpu/serving/api_server.py``:

  POST /generate      {"num_samples": N, "seed": S, "inference_steps": K,
                       "guidance_scale": W, "output_format": "base64"|"nii",
                       "sampler": "ddpm"|"ddim"|"dpm"|"dpm3"|"distilled" (optional),
                       "timestep_spacing": "leading"|"trailing"|"karras" (optional),
                       "condition": {"data": <base64 float32>, "shape": [D, H, W]} (optional)}
                      -> base64 volumes (raw float32 or NIfTI-1 bytes)
  GET  /health        liveness/readiness payload
  GET  /metrics       Prometheus text format
  GET  /model/info    model + device metadata
  POST /model/reload  reload checkpoints

It serves through the standard library's ThreadingHTTPServer only, with the
same CORS and gzip contract as the JAX package's FastAPI front end, which is
not ported (ROADMAP.md queue A, item 2). SIGTERM drains in-flight requests.

Run: python -m ldm3d_torch.serving.api_server --port 8000 -c CONFIG -e ENV [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from ldm3d_torch.serving.metrics import REGISTRY, Counter, Gauge, Histogram
from ldm3d_torch.serving.model_server import ModelServer

log = logging.getLogger("api_server")

REQUEST_COUNT = REGISTRY.register(Counter(
    "api_requests_total", "Total API requests", labels=("method", "endpoint", "status")))
REQUEST_DURATION = REGISTRY.register(Histogram(
    "api_request_duration_seconds", "API request duration"))
INFERENCE_DURATION = REGISTRY.register(Histogram(
    "model_inference_duration_seconds", "Model inference duration"))
ACTIVE_REQUESTS = REGISTRY.register(Gauge(
    "api_active_requests", "Currently active requests"))
MEMORY_USAGE = REGISTRY.register(Gauge(
    "process_memory_bytes", "Process RSS bytes"))
DEVICE_MEMORY_USAGE = REGISTRY.register(Gauge(
    "device_memory_bytes", "CUDA device memory allocated by the server's tensors"))
MICROBATCHES = REGISTRY.register(Gauge(
    "sampler_microbatches_total", "Sampler calls made by the micro-batcher"))
MICROBATCHED_SAMPLES = REGISTRY.register(Gauge(
    "sampler_microbatched_samples_total", "Samples served through the micro-batcher"))


def process_rss_bytes() -> "int | None":
    """This process's resident set size from ``/proc/self/status``; None
    where that file does not exist."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class Api:
    """Framework-agnostic handlers; the HTTP front end delegates here."""

    def __init__(self, server: ModelServer):
        import threading

        self.server = server
        self.started = time.time()
        # in-flight request tracking for graceful drain: ThreadingHTTPServer
        # handler threads are daemons, so server_close() joins nothing —
        # serve_stdlib waits on this instead before letting the process exit.
        # The stdlib Handler brackets the WHOLE request (body read, dispatch,
        # response write — response bytes can be tens of MB of base64).
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()

    def request_started(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()

    def request_finished(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()

    def drain(self, timeout: float) -> bool:
        """Wait until no request is executing; False if ``timeout`` hit."""
        return self._idle.wait(timeout)

    def health(self) -> tuple[int, dict]:
        rss = process_rss_bytes()
        if rss is not None:
            MEMORY_USAGE.set(rss)
        device = getattr(self.server, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            DEVICE_MEMORY_USAGE.set(float(torch.cuda.memory_allocated(device)))
        status = "healthy" if self.server.model_loaded else "degraded"
        return 200, {
            "status": status,
            "model_loaded": self.server.model_loaded,
            "dummy_model": self.server.is_dummy,
            "uptime_seconds": time.time() - self.started,
        }

    def generate(self, body: dict) -> tuple[int, dict]:
        try:
            num = int(body.get("num_samples", 1))
            seed = body.get("seed")
            if seed is not None:
                seed = int(seed)
            # reference GenerationRequest fields (mlops/docker/api_server.py:51-56)
            steps = body.get("inference_steps")
            if steps is not None:
                steps = int(steps)
            guidance = body.get("guidance_scale")
            if guidance is not None:
                guidance = float(guidance)
        except (TypeError, ValueError, AttributeError) as e:
            # a non-numeric field (or a non-object body) is the client's
            # error — 422 like every other validation, not a 500
            return 422, {"error": f"invalid request field: {e}"}
        if not (1 <= num <= 16):
            return 422, {"error": "num_samples must be in [1, 16]"}
        if steps is not None and not (10 <= steps <= 1000):
            return 422, {"error": "inference_steps must be in [10, 1000]"}
        if guidance is not None and not (1.0 <= guidance <= 20.0):
            return 422, {"error": "guidance_scale must be in [1.0, 20.0]"}
        output_format = str(body.get("output_format", "base64"))
        if output_format not in ("base64", "nii"):
            return 422, {"error": "output_format must be 'base64' or 'nii'"}
        # beyond the reference schema: per-request sampler/spacing selection
        from ldm3d_torch.cli.common import SAMPLERS, TIMESTEP_SPACINGS

        sampler = body.get("sampler")
        if sampler is not None and sampler not in SAMPLERS + ("distilled",):
            return 422, {"error": f"sampler must be one of {'|'.join(SAMPLERS)}|distilled"}
        spacing = body.get("timestep_spacing")
        if spacing is not None and spacing not in TIMESTEP_SPACINGS:
            return 422, {"error": f"timestep_spacing must be one of "
                                  f"{'|'.join(TIMESTEP_SPACINGS)}"}
        # optional low-count conditioning volume for concat-conditional
        # models: {"condition": {"data": <base64 float32>, "shape": [D,H,W]}}
        condition_volume = None
        cond = body.get("condition")
        if cond is not None:
            import base64 as _b64

            import numpy as np
            try:
                raw = _b64.b64decode(cond["data"])
                condition_volume = np.frombuffer(raw, np.float32).reshape(cond["shape"])
            except (KeyError, ValueError, TypeError) as e:
                return 422, {"error": f"bad condition payload: {e}"}
        t0 = time.time()
        try:
            result = self.server.generate(num_samples=num, seed=seed,
                                          condition_volume=condition_volume,
                                          inference_steps=steps,
                                          guidance_scale=guidance,
                                          output_format=output_format,
                                          sampler=sampler,
                                          timestep_spacing=spacing)
        except ValueError as e:
            return 422, {"error": str(e)}
        except RuntimeError as e:
            return 503, {"error": str(e)}
        INFERENCE_DURATION.observe(time.time() - t0)
        return 200, result

    def model_info(self) -> tuple[int, dict]:
        return 200, self.server.model_info()

    def reload(self) -> tuple[int, dict]:
        self.server.load_model()
        return 200, {"reloaded": True, "dummy": self.server.is_dummy}

    def metrics_text(self) -> str:
        b = getattr(self.server, "_batcher", None)
        if b is not None:
            MICROBATCHES.set(b.batches_run)
            MICROBATCHED_SAMPLES.set(b.samples_run)
        return REGISTRY.expose()

    _ENDPOINTS = ("/health", "/metrics", "/model/info", "/model/reload", "/generate")

    def dispatch(self, method: str, path: str, body: dict) -> tuple[int, object, str]:
        """Returns (status, payload, content_type)."""
        path = path.split("?", 1)[0]  # probes may append query params
        ACTIVE_REQUESTS.inc()
        t0 = time.time()
        code = 500
        try:
            if method == "GET" and path == "/health":
                code, payload = self.health()
            elif method == "GET" and path == "/metrics":
                code, payload = 200, self.metrics_text()
                return code, payload, "text/plain; version=0.0.4"
            elif method == "GET" and path == "/model/info":
                code, payload = self.model_info()
            elif method == "POST" and path == "/model/reload":
                code, payload = self.reload()
            elif method == "POST" and path == "/generate":
                code, payload = self.generate(body)
            else:
                code, payload = 404, {"error": f"unknown endpoint {method} {path}"}
            return code, payload, "application/json"
        except Exception:  # never leave the client without a response
            log.exception("unhandled error in %s %s", method, path)
            return 500, {"error": "internal server error"}, "application/json"
        finally:
            ACTIVE_REQUESTS.dec()
            dur = time.time() - t0
            REQUEST_DURATION.observe(dur)
            # per-status counters (reference api_server.py:273-294 parity):
            # label with the code actually returned, not a constant. Unknown
            # paths collapse to one label so a URL scanner can't grow the
            # metric set (and /metrics output) without bound.
            label_path = path if path in self._ENDPOINTS else "<other>"
            REQUEST_COUNT.labels(method, label_path, str(code)).inc()


# the reference's middleware: CORS with wildcard origins + credentials, and
# gzip for responses >= 1000 bytes (the base64 volume payloads are MB-scale)
GZIP_MIN_SIZE = 1000
CORS_ALLOW_ORIGINS = ("*",)


def make_stdlib_server(api: Api, host: str, port: int,
                       cors_origins=CORS_ALLOW_ORIGINS):
    """Build (without starting) the stdlib ThreadingHTTPServer; port 0 picks
    a free port. CORS (OPTIONS preflight, allow-origin on every response) and
    gzip for bodies >= GZIP_MIN_SIZE when the client accepts it."""
    import gzip as _gzip
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    allow_any = "*" in cors_origins

    class Handler(BaseHTTPRequestHandler):
        def _cors_origin(self):
            """The Access-Control-Allow-Origin value for this request, or
            None. With credentials allowed, '*' must echo the request origin
            (the literal '*' is rejected by browsers for credentialed
            requests) — Starlette's CORSMiddleware does the same."""
            origin = self.headers.get("Origin")
            if origin and (allow_any or origin in cors_origins):
                return origin
            return "*" if allow_any else None

        def _respond(self, method):
            api.request_started()
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = {}
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        self._send(400, {"error": "invalid JSON body"}, "application/json")
                        return
                code, payload, ctype = api.dispatch(method, self.path, body)
                self._send(code, payload, ctype)
            finally:
                api.request_finished()

        def _send(self, code, payload, ctype):
            data = payload.encode() if isinstance(payload, str) else json.dumps(payload).encode()
            encoding = None
            if (len(data) >= GZIP_MIN_SIZE
                    and "gzip" in (self.headers.get("Accept-Encoding") or "")):
                data = _gzip.compress(data)
                encoding = "gzip"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            if encoding:
                self.send_header("Content-Encoding", encoding)
                self.send_header("Vary", "Accept-Encoding")
            origin = self._cors_origin()
            if origin:
                self.send_header("Access-Control-Allow-Origin", origin)
                self.send_header("Access-Control-Allow-Credentials", "true")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._respond("GET")

        def do_POST(self):
            self._respond("POST")

        def do_OPTIONS(self):
            # CORS preflight: no dispatch, just the allow headers
            self.send_response(204)
            origin = self._cors_origin()
            if origin:
                self.send_header("Access-Control-Allow-Origin", origin)
                self.send_header("Access-Control-Allow-Credentials", "true")
                self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
                self.send_header("Access-Control-Allow-Headers",
                                 self.headers.get("Access-Control-Request-Headers") or "*")
                self.send_header("Access-Control-Max-Age", "600")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, fmt, *a):
            log.info("%s - " + fmt, self.address_string(), *a)

    return ThreadingHTTPServer((host, port), Handler)


def serve_stdlib(api: Api, host: str, port: int, drain_timeout: float = 120.0,
                 cors_origins=CORS_ALLOW_ORIGINS):
    """Serve until SIGTERM/SIGINT, then drain gracefully: stop accepting,
    finish in-flight requests, retire the micro-batcher (K8s sends SIGTERM on
    pod shutdown; without this the default handler kills requests mid-flight).

    ThreadingHTTPServer handler threads are daemons, so ``server_close()``
    joins nothing — the drain waits on the Api's in-flight counter (bounded
    by ``drain_timeout``; keep it under the pod's terminationGracePeriod)."""
    import signal
    import threading

    httpd = make_stdlib_server(api, host, port, cors_origins=cors_origins)
    log.info("stdlib HTTP server on %s:%d", host, port)

    def _shutdown(signum, frame):
        log.info("signal %d: draining and shutting down", signum)
        # shutdown() blocks until serve_forever exits; run it off the
        # signal-handler thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _shutdown)
        except ValueError:  # pragma: no cover - non-main thread
            pass
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()  # stop accepting; in-flight daemon threads continue
        if not api.drain(drain_timeout):
            log.warning("drain timed out after %.0fs with requests in flight",
                        drain_timeout)
        batcher = getattr(api.server, "_batcher", None)
        if batcher is not None:
            batcher.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        log.info("server stopped")


def main(argv=None):
    p = argparse.ArgumentParser(description="ldm3d_torch model server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("-c", "--config-file", default=None)
    p.add_argument("-e", "--environment-file", default=None)
    from ldm3d_torch.cli.common import SAMPLERS, TIMESTEP_SPACINGS

    p.add_argument("--sampler", choices=SAMPLERS + ("distilled",), default="ddim",
                   help="'distilled' serves the progressively-distilled student "
                        "(cli.distill) on its fixed few-step grid")
    p.add_argument("--steps", type=int, default=None,
                   help="inference steps (default: 50 for ddim/dpm/dpm3, the full schedule "
                        "for ddpm; a value strides ddpm)")
    p.add_argument("--timestep-spacing", choices=TIMESTEP_SPACINGS, default=None,
                   help="server-default sampling grid (default: the config's; per-request "
                        "'timestep_spacing' overrides)")
    p.add_argument("--batch", type=int, default=1,
                   help="volumes per sampler call (multi-sample requests run in chunks; "
                        "concurrent single-volume requests are micro-batched)")
    p.add_argument("--decode-chunk", default="0",
                   help="decode sampled batches in chunks of N volumes (0 = whole batch; "
                        "'auto' probes the device-to-host rate at load)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; pass cpu to serve on the CPU)")
    p.add_argument("--cors-origins", default="*",
                   help="comma-separated allowed CORS origins (default '*')")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    decode_chunk = args.decode_chunk if args.decode_chunk == "auto" else int(args.decode_chunk)
    server = ModelServer(args.config_file, args.environment_file, args.sampler, args.steps,
                         batch=args.batch, decode_chunk=decode_chunk,
                         timestep_spacing=args.timestep_spacing, device=args.device)
    server.load_model()
    cors_origins = tuple(o.strip() for o in args.cors_origins.split(",") if o.strip())
    serve_stdlib(Api(server), args.host, args.port, cors_origins=cors_origins)


if __name__ == "__main__":
    main()
