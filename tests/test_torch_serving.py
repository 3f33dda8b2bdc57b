"""The port's serving contract: REST API, metrics, scoring, health check.

The cases of ``tests/test_serving.py`` that need no multi-chip mesh, no
FastAPI and no distilled student, on the port's server: the dummy model
(missing artifacts) behind ``Api`` and the stdlib HTTP server, the sampler
variant cache with a fake build function, reload against in-flight work,
SIGTERM drain, the health-check exit codes, and the port's own rule that
only missing files fall back to the dummy (no CUDA raises). No JAX here.
The real pipeline's cases are in ``test_torch_serving_real.py``, its parity
with the JAX server in ``test_torch_serving_parity.py``.
"""

import base64
import json
import os
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ldm3d_torch.serving.api_server import Api, make_stdlib_server
from ldm3d_torch.serving.metrics import Counter, Gauge, Histogram, Registry
from ldm3d_torch.serving.model_server import ModelServer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def port_two_stage(root: Path, seed: int = 0, scale_factor: float = 0.8) -> tuple[str, str]:
    """Seeded init weights of the ``config_tiny_cpu`` AE + UNet written as the
    port's ``best`` checkpoints (the UNet's zero-init output conv made
    non-zero, so every layer reaches the output); returns ``(config, env)``."""
    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.nn import init_weights_

    cfg = preset_path("config_tiny_cpu.json")
    ns = SimpleNamespace(**load_json(cfg))
    gen = torch.Generator().manual_seed(seed)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    save_two_stage(str(root / "ckpt"), ae, unet, scale_factor)
    env = root / "env.json"
    env.write_text(json.dumps({"model_dir": str(root / "ckpt"), "output_dir": str(root / "out"),
                               "seed": 0}))
    return cfg, str(env)


def http(port, method, path, body=None, headers=None):
    """One HTTP round trip; returns (status, lower-cased headers, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    h = dict(headers or {})
    if body:
        h.setdefault("Content-Type", "application/json")
    conn.request(method, path, body=body, headers=h)
    resp = conn.getresponse()
    data = resp.read()
    hdrs = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    return resp.status, hdrs, data


class serving:
    """Context manager: the stdlib server of ``api`` on a daemon thread."""

    def __init__(self, api, **kw):
        self.httpd = make_stdlib_server(api, "127.0.0.1", 0, **kw)

    def __enter__(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self.httpd.server_address[1]

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def api():
    server = ModelServer(None, None, device="cpu")  # no config -> dummy fallback
    server.load_model()
    assert server.is_dummy
    return Api(server)


def test_health(api):
    code, payload = api.health()
    assert code == 200
    assert payload["status"] == "healthy"
    assert payload["model_loaded"] is True
    assert payload["dummy_model"] is True


def test_generate_contract_and_response_fields(api):
    code, payload, ctype = api.dispatch("POST", "/generate", {"num_samples": 2, "seed": 1})
    assert code == 200 and ctype == "application/json"
    assert payload["num_samples"] == 2
    s = payload["samples"][0]
    arr = np.frombuffer(base64.b64decode(s["data"]), dtype=np.float32)
    assert arr.size == np.prod(s["shape"])
    assert np.isfinite(arr).all()
    assert 0.0 <= arr.min() and arr.max() <= 1.0  # min-max normalised
    for field in ("status", "request_id", "num_samples", "inference_steps",
                  "guidance_scale", "output_format", "processing_time_ms", "samples"):
        assert field in payload, field
    assert payload["status"] == "success" and len(payload["request_id"]) == 32


@pytest.mark.parametrize("body,field", [
    ({"num_samples": 99}, "num_samples"),
    ({"num_samples": "abc"}, "invalid request field"),
    ({"guidance_scale": "x"}, "invalid request field"),
    ({"inference_steps": 5}, "inference_steps"),
    ({"guidance_scale": 50.0}, "guidance_scale"),
    ({"output_format": "tiff"}, "output_format"),
    ({"sampler": "plms"}, "sampler"),
    ({"timestep_spacing": "fibonacci"}, "timestep_spacing"),
    ({"condition": {"data": "!!notbase64", "shape": [1]}}, "condition"),
    ([1, 2], "invalid request field"),
])
def test_generate_validation(api, body, field):
    code, payload, _ = api.dispatch("POST", "/generate", body)
    assert code == 422 and field in payload["error"]


def test_unknown_endpoint_and_query_string(api):
    assert api.dispatch("GET", "/nope", {})[0] == 404
    assert api.dispatch("GET", "/health?probe=1", {})[0] == 200


def test_metrics_exposition_and_status_labels(api):
    from ldm3d_torch.serving.api_server import REQUEST_COUNT

    api.dispatch("POST", "/generate", {"num_samples": 99})  # 422
    api.dispatch("GET", "/nope", {})                         # 404
    api.dispatch("GET", "/health", {})                       # 200
    text = api.metrics_text()
    assert "# TYPE api_requests_total counter" in text
    assert "api_request_duration_seconds_bucket" in text
    assert "process_memory_bytes" in text
    counts = {labels: v for labels, v in REQUEST_COUNT.collect()}
    assert counts.get(("POST", "/generate", "422"), 0) >= 1
    assert counts.get(("GET", "<other>", "404"), 0) >= 1  # unknown paths: one label
    assert counts.get(("GET", "/health", "200"), 0) >= 1
    assert not any(lbl[1] == "/nope" for lbl in counts)


def test_dispatch_internal_error_returns_500(api, monkeypatch):
    from ldm3d_torch.serving.api_server import REQUEST_COUNT

    def boom(body):
        raise KeyError("boom")

    monkeypatch.setattr(api, "generate", boom)
    code, payload, _ = api.dispatch("POST", "/generate", {})
    assert code == 500 and "error" in payload
    counts = {labels: v for labels, v in REQUEST_COUNT.collect()}
    assert counts.get(("POST", "/generate", "500"), 0) >= 1


def test_model_info(api):
    code, info = api.model_info()
    assert code == 200 and info["dummy"] is True
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]


def test_metrics_primitives():
    reg = Registry()
    c = reg.register(Counter("c_total", "c", labels=("x",)))
    c.labels("a").inc()
    c.labels("a").inc(2)
    g = reg.register(Gauge("g", "g"))
    g.set(5)
    g.dec()
    h = reg.register(Histogram("h_seconds", "h", buckets=(0.1, 1.0, float("inf"))))
    h.observe(0.05)
    h.observe(0.5)
    text = reg.expose()
    assert 'c_total{x="a"} 3.0' in text
    assert "g 4.0" in text
    assert 'h_seconds_bucket{le="0.1"} 1' in text
    assert "h_seconds_count 2" in text
    with pytest.raises(ValueError, match="labels"):
        c.labels("a", "b")


def test_score_contract(monkeypatch):
    from ldm3d_torch.serving import score

    monkeypatch.setenv("LDM_DEVICE", "cpu")
    score.init()
    out = json.loads(score.run(json.dumps({"num_samples": 1, "seed": 0})))
    assert "samples" in out
    assert "error" in json.loads(score.run("{not json"))


def test_stdlib_http_roundtrip(api):
    with serving(api) as port:
        code, hdrs, data = http(port, "GET", "/health")
        assert code == 200 and "json" in hdrs["content-type"]
        assert json.loads(data)["model_loaded"] is True
        code, _, data = http(port, "POST", "/generate", json.dumps({"num_samples": 1, "seed": 3}))
        assert code == 200
        payload = json.loads(data)
        arr = np.frombuffer(base64.b64decode(payload["samples"][0]["data"]), np.float32)
        assert arr.size == np.prod(payload["samples"][0]["shape"])
        code, hdrs, data = http(port, "GET", "/metrics")
        assert code == 200 and hdrs["content-type"].startswith("text/plain")
        assert b"api_requests_total" in data
        assert http(port, "GET", "/nonexistent")[0] == 404
        code, _, data = http(port, "POST", "/generate", "{not json")
        assert code == 400 and b"invalid JSON" in data


def test_stdlib_cors_and_gzip(api):
    import gzip

    from ldm3d_torch.serving.api_server import GZIP_MIN_SIZE

    assert GZIP_MIN_SIZE == 1000
    with serving(api) as port:
        code, hdrs, _ = http(port, "OPTIONS", "/generate", headers={
            "Origin": "http://dash.example", "Access-Control-Request-Method": "POST",
            "Access-Control-Request-Headers": "content-type"})
        assert code == 204
        assert hdrs["access-control-allow-origin"] == "http://dash.example"
        assert "POST" in hdrs["access-control-allow-methods"]
        assert hdrs["access-control-allow-headers"] == "content-type"
        code, hdrs, _ = http(port, "GET", "/health", headers={"Origin": "http://dash.example"})
        assert hdrs["access-control-allow-origin"] == "http://dash.example"
        assert hdrs["access-control-allow-credentials"] == "true"
        body = json.dumps({"num_samples": 1, "seed": 3})
        code, hdrs, data = http(port, "POST", "/generate", body,
                                headers={"Accept-Encoding": "gzip"})
        assert code == 200 and hdrs.get("content-encoding") == "gzip"
        assert int(hdrs["content-length"]) == len(data)
        assert len(json.loads(gzip.decompress(data))["samples"]) == 1
        code, hdrs, data = http(port, "GET", "/health", headers={"Accept-Encoding": "gzip"})
        assert "content-encoding" not in hdrs
        json.loads(data)
        code, hdrs, data = http(port, "POST", "/generate", body)
        assert "content-encoding" not in hdrs
    with serving(api, cors_origins=("http://ok.example",)) as port:
        _, hdrs, _ = http(port, "GET", "/health", headers={"Origin": "http://ok.example"})
        assert hdrs["access-control-allow-origin"] == "http://ok.example"
        _, hdrs, _ = http(port, "GET", "/health", headers={"Origin": "http://evil.example"})
        assert "access-control-allow-origin" not in hdrs


def test_stdlib_server_sigterm_drains(tmp_path):
    """SIGTERM drains: the in-flight request finishes with its 200 and the
    process exits 0 (the pod-shutdown path)."""
    import signal
    import subprocess

    script = tmp_path / "srv.py"
    script.write_text(
        "import socket, time\n"
        "from ldm3d_torch.serving.api_server import Api, serve_stdlib\n"
        "from ldm3d_torch.serving.model_server import ModelServer\n"
        "s = ModelServer(None, None, device='cpu')\n"
        "s.load_model()\n"
        "_orig = s.generate\n"
        "def _slow(*a, **k):\n"
        "    time.sleep(2.0)  # hold a request in flight across the SIGTERM\n"
        "    return _orig(*a, **k)\n"
        "s.generate = _slow\n"
        "sock = socket.socket(); sock.bind(('127.0.0.1', 0))\n"
        "port = sock.getsockname()[1]; sock.close()\n"
        "print(f'PORT={port}', flush=True)\n"
        "serve_stdlib(Api(s), '127.0.0.1', port)\n"
        "print('CLEAN-EXIT', flush=True)\n")
    proc = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT))
    try:
        port = None
        deadline = time.time() + 120
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if line.startswith("PORT="):
                port = int(line.strip().split("=")[1])
        assert port, "server never reported its port"
        for _ in range(100):
            try:
                assert http(port, "GET", "/health")[0] == 200
                break
            except OSError:
                time.sleep(0.2)
        else:
            raise AssertionError("server never became reachable")
        inflight = {}
        t = threading.Thread(target=lambda: inflight.update(status=http(
            port, "POST", "/generate", '{"num_samples": 1, "seed": 0}')[0]))
        t.start()
        time.sleep(0.7)  # the request is inside the slow generate()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        t.join(30)
        assert proc.returncode == 0, out[-2000:]
        assert "CLEAN-EXIT" in out
        assert inflight.get("status") == 200, "in-flight request was killed by shutdown"
    finally:
        if proc.poll() is None:
            proc.kill()


def test_health_check_exit_code_contract(api, tmp_path):
    from ldm3d_torch.serving.health_check import check_device, main as health_main

    with serving(api) as port:
        assert health_main(["--skip-device", "--api-url", f"http://127.0.0.1:{port}"]) == 0
        assert health_main(["--skip-device", "--api-url", "http://127.0.0.1:9"]) == 1
        assert health_main(["--skip-device", "--model-dir", str(tmp_path / "nope")]) == 1
    assert check_device()["ok"] is torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert health_main([]) == 1  # no card: unhealthy


def test_health_check_reads_proc_meminfo(tmp_path):
    from ldm3d_torch.serving.health_check import check_model_files, memory_used_pct

    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal:       1000 kB\nMemFree:   100 kB\nMemAvailable:    250 kB\n")
    assert memory_used_pct(str(meminfo)) == 75.0
    (tmp_path / "autoencoder_best.pt").write_bytes(b"")
    assert check_model_files(str(tmp_path))["missing"] == [str(tmp_path / "diffusion_best.pt")]


def test_reload_excludes_inflight_generate(monkeypatch):
    """/model/reload never swaps the pipeline under an in-flight /generate:
    it waits for the request, and requests behind a waiting reload queue
    after it (writer-preferring)."""
    from ldm3d_torch.serving import model_server as ms

    server = ModelServer(None, None, device="cpu")
    server.load_model()
    entered, release = threading.Event(), threading.Event()
    real_sleep = time.sleep

    def slow_sleep(_t):  # the dummy generate's latency shim, made controllable
        entered.set()
        assert release.wait(10), "test deadlock: release never set"

    monkeypatch.setattr(ms.time, "sleep", slow_sleep)
    order, result, late = [], {}, {}
    t_gen = threading.Thread(target=lambda: (result.update(resp=server.generate(1, seed=0)),
                                             order.append("generate")))
    t_gen.start()
    assert entered.wait(10)
    t_reload = threading.Thread(target=lambda: (server.load_model(), order.append("reload")))
    t_reload.start()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not server._reload_gate._writers_waiting:
        real_sleep(0.01)
    assert t_reload.is_alive() and server._reload_gate._writers_waiting == 1
    t_late = threading.Thread(target=lambda: late.update(resp=server.generate(1, seed=1)))
    t_late.start()
    real_sleep(0.05)
    assert "resp" not in late  # parked behind the reload
    release.set()
    for t in (t_gen, t_reload, t_late):
        t.join(10)
        assert not t.is_alive()
    assert order[0] == "generate" and "reload" in order
    assert result["resp"]["status"] == late["resp"]["status"] == "success"


# -- sampler-variant cache (fake build function) ------------------------------

def _bare_server(build_run, sampler="ddim", steps=4):
    s = ModelServer(None, None, sampler=sampler, steps=steps, device="cpu")
    s._build_run = build_run
    return s


def test_variant_build_does_not_block_cache_hits():
    gate = threading.Event()

    def build(name, steps, guidance, spacing=None):
        if steps == 99:
            assert gate.wait(timeout=10)
        return ("prog", name, steps, guidance)

    s = _bare_server(build)
    fast = s._get_run("ddim", 4, 1.0)
    slow = {}
    t = threading.Thread(target=lambda: slow.setdefault("fn", s._get_run("ddim", 99, 1.0)))
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    assert s._get_run("ddim", 4, 1.0) is fast
    assert time.perf_counter() - t0 < 1.0, "cache hit blocked behind a build"
    gate.set()
    t.join(10)
    assert slow["fn"] == ("prog", "ddim", 99, 1.0)


def test_variant_duplicate_requests_build_once():
    calls, started, gate = [], threading.Event(), threading.Event()

    def build(name, steps, guidance, spacing=None):
        calls.append(steps)
        started.set()
        assert gate.wait(timeout=10)
        return ("prog", steps)

    s = _bare_server(build)
    results = []
    threads = [threading.Thread(target=lambda: results.append(s._get_run("ddim", 7, 1.0)))
               for _ in range(4)]
    for t in threads:
        t.start()
    assert started.wait(timeout=10)
    gate.set()
    for t in threads:
        t.join(10)
    assert calls == [7] and results == [("prog", 7)] * 4


def test_variant_build_failure_propagates_and_retries():
    attempts, fail_gate = [], threading.Event()

    def build(name, steps, guidance, spacing=None):
        attempts.append(steps)
        if len(attempts) == 1:
            assert fail_gate.wait(timeout=10)
            raise ValueError("build exploded")
        return ("prog", steps)

    s = _bare_server(build)
    errors, waiter_done = [], threading.Event()

    def owner():
        try:
            s._get_run("ddim", 11, 1.0)
        except ValueError as e:
            errors.append(("owner", e))

    def waiter():
        try:
            s._get_run("ddim", 11, 1.0)
        except RuntimeError as e:
            errors.append(("waiter", e))
        waiter_done.set()

    t1 = threading.Thread(target=owner)
    t1.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=waiter)
    t2.start()
    time.sleep(0.05)
    fail_gate.set()
    t1.join(10)
    assert waiter_done.wait(timeout=10)
    assert "owner" in [k for k, _ in errors]
    assert s._get_run("ddim", 11, 1.0) == ("prog", 11)  # a failure never poisons the cache
    assert len(attempts) >= 2


def test_variant_cache_evicts_lru_keeps_default():
    s = _bare_server(lambda name, steps, guidance, spacing=None: ("prog", steps))
    s._sampler_cache_max = 3
    default = s._get_run("ddim", 4, 1.0)
    s._get_run("ddim", 10, 1.0)
    s._get_run("ddim", 20, 1.0)
    s._get_run("ddim", 10, 1.0)  # 20 is now the LRU
    s._get_run("ddim", 30, 1.0)
    assert {k[1] for k in s._sampler_cache} == {4, 10, 30}
    assert s._get_run("ddim", 4, 1.0) is default


def test_variant_cache_bound_restored_after_inflight_publishes():
    gates: dict = {}

    def build(name, steps, guidance, spacing=None):
        assert gates[steps].wait(10)
        return ("prog", steps)

    s = _bare_server(build)
    s._sampler_cache_max = 2
    gates[4] = threading.Event()
    gates[4].set()
    s._get_run("ddim", 4, 1.0)
    threads = []
    for n in (10, 20, 30):
        gates[n] = threading.Event()
        t = threading.Thread(target=lambda n=n: s._get_run("ddim", n, 1.0))
        t.start()
        threads.append(t)
    for _ in range(100):
        if len(s._sampler_cache) == 4:
            break
        time.sleep(0.05)
    assert len(s._sampler_cache) == 4  # transient overflow of placeholders
    for n in (10, 20, 30):
        gates[n].set()
    for t in threads:
        t.join(10)
    assert len(s._sampler_cache) <= s._sampler_cache_max
    assert ("ddim", 4, 1.0, None) in s._sampler_cache


def test_decode_chunk_auto(monkeypatch):
    import logging

    from ldm3d_torch.cli import common

    monkeypatch.setattr(common, "probe_readback_gbps", lambda *a: 8.0)
    assert common.resolve_decode_chunk("auto", logging.getLogger(__name__)) == 0
    monkeypatch.setattr(common, "probe_readback_gbps", lambda *a: 0.07)
    assert common.resolve_decode_chunk("auto") == 1
    assert common.resolve_decode_chunk(3) == 3
    assert common.resolve_decode_chunk("0") == 0
    assert common.resolve_decode_chunk(-2) == 0
    monkeypatch.undo()
    assert common.probe_readback_gbps("cpu", nbytes=1 << 16) > 0
    with pytest.raises(ValueError, match="auto"):
        ModelServer(None, None, decode_chunk="whole", device="cpu")
    assert ModelServer(None, None, decode_chunk="auto", device="cpu").decode_chunk == "auto"


# -- what the port does not hide behind the dummy ------------------------------

def test_no_cuda_raises_not_dummy(tmp_path):
    """Only missing artifacts fall back to the dummy: without a CUDA device a
    cuda server raises (at construction), with or without a config."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg, env = port_two_stage(tmp_path)
    for args in ((cfg, env), (None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelServer(*args, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(cfg, env)  # cuda is the default


def test_config_errors_fail_loudly_not_dummy(tmp_path):
    """Statically invalid combinations fail at construction, config-dependent
    ones at load_model; missing artifacts still fall back; unported
    multi-card serving names its ROADMAP item. A distilled server, as the
    JAX server: the dummy without a config; with one but no distilled
    checkpoint, ``ValueError``."""
    with pytest.raises(ValueError, match="ddpm"):
        ModelServer(None, None, sampler="ddpm", timestep_spacing="karras", device="cpu")
    with pytest.raises(ValueError, match="timestep_spacing"):
        ModelServer(None, None, timestep_spacing="quadratic", device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.*11"):
        ModelServer(None, None, spatial=2, device="cpu")
    distilled = ModelServer(None, None, sampler="distilled", device="cpu")
    distilled.load_model()
    assert distilled.model_loaded and distilled.is_dummy
    cfg, env = port_two_stage(tmp_path)
    distilled = ModelServer(cfg, env, sampler="distilled", device="cpu")
    with pytest.raises(ValueError, match="no distilled checkpoint in .*run ldm3d-distill first"):
        distilled.load_model()
    assert not distilled.model_loaded
    # the tiny config trains 16 timesteps: a 10-step karras grid has duplicates
    srv = ModelServer(cfg, env, sampler="dpm", steps=10, timestep_spacing="karras", device="cpu")
    with pytest.raises(ValueError, match="karras"):
        srv.load_model()
    assert not srv.model_loaded
    missing = ModelServer(cfg, str(tmp_path / "no_env.json"), device="cpu")
    missing.load_model()
    assert missing.is_dummy
    (tmp_path / "ckpt" / "diffusion_best.pt").unlink()
    no_ckpt = ModelServer(cfg, env, device="cpu")
    no_ckpt.load_model()
    assert no_ckpt.is_dummy
