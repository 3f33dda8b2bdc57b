"""The port's server on the real two-stage pipeline (``config_tiny_cpu``).

The cases of ``tests/test_serving.py`` that run the real (non-dummy)
pipeline, on the port with seeded init weights, on the CPU: conditional
generation, determinism per seed, chunked batches and decode chunks, the
micro-batcher (a volume served in a merged batch equals it served alone:
the sampler's batch is always the server's), the ddpm gate, per-request
sampler, steps, spacing, guidance and NIfTI output, and the variant cache
bound under a scan of request shapes. No JAX here.
"""

import base64
import threading

import numpy as np
import pytest
import torch
from test_torch_serving import http, port_two_stage, serving

from ldm3d_torch.serving.api_server import Api
from ldm3d_torch.serving.model_server import ModelServer

torch.set_num_threads(1)


def _vol(out, i=0):
    return np.frombuffer(base64.b64decode(out["samples"][i]["data"]), np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return port_two_stage(tmp_path_factory.mktemp("serving_real"))


@pytest.fixture(scope="module")
def real_api(files):
    server = ModelServer(*files, sampler="ddim", steps=2, device="cpu")
    server.load_model()
    assert not server.is_dummy, "real pipeline failed to load"
    return Api(server)


@pytest.fixture(scope="module")
def batched(files):
    """batch 2, ddim: micro-batched; a 2 s window (not 10 ms) makes merging
    robust on a loaded machine."""
    srv = ModelServer(*files, sampler="ddim", steps=2, batch=2, device="cpu")
    srv.load_model()
    assert not srv.is_dummy and srv._batcher is not None
    srv._batcher.max_wait = 2.0
    yield srv
    srv._batcher.close()


def test_real_conditional_generate(real_api):
    srv = real_api.server
    vol = np.random.default_rng(0).random(srv.patch_size, dtype=np.float32)
    out = srv.generate(1, seed=0, condition_volume=vol)
    assert out["conditioning"] == "provided" and out["model_version"] == "ldm3d_torch"
    arr = _vol(out)
    assert np.isfinite(arr).all() and arr.size == np.prod(srv.patch_size)
    np.testing.assert_array_equal(arr, _vol(srv.generate(1, seed=0, condition_volume=vol)))
    assert srv.generate(1, seed=0)["conditioning"] == "random"
    with pytest.raises(ValueError, match="does not match"):
        srv.generate(1, condition_volume=np.zeros((8, 8, 8), np.float32))


def test_real_conditional_generate_over_http(real_api):
    import json

    patch = real_api.server.patch_size
    vol = np.random.default_rng(1).random(patch, dtype=np.float32)
    body = {"num_samples": 1, "seed": 3,
            "condition": {"data": base64.b64encode(vol.tobytes()).decode("ascii"),
                          "shape": list(patch)}}
    with serving(real_api) as port:
        code, _, data = http(port, "POST", "/generate", json.dumps(body))
        assert code == 200
        payload = json.loads(data)
        assert payload["conditioning"] == "provided" and payload["sampler"] == "ddim"
        assert payload["timestep_spacing"] == "leading"
        code, _, data = http(port, "GET", "/model/info")
        assert json.loads(data)["dummy"] is False


def test_batched_sampler_chunks_and_decode_chunk(files, batched):
    """batch 2: a 3-volume request runs two batch-2 calls, trimmed to 3; a
    server decoding a volume at a time returns the same volumes up to the
    CPU convolutions' batch-size-dependent summation order."""
    out = batched.generate(3, seed=0)
    assert out["num_samples"] == 3 and len(out["samples"]) == 3
    assert all(np.isfinite(_vol(out, i)).all() for i in range(3))
    chunked = ModelServer(*files, sampler="ddim", steps=2, batch=2, decode_chunk=1,
                          device="cpu")
    chunked.load_model()
    out_c = chunked.generate(2, seed=7)
    out_w = batched.generate(2, seed=7)
    for i in range(2):
        np.testing.assert_allclose(_vol(out_c, i), _vol(out_w, i), atol=1e-5, rtol=0)
    chunked._batcher.close()


def test_micro_batcher_merges_and_is_exact(batched):
    solo = _vol(batched.generate(1, seed=11))
    runs_before = batched._batcher.batches_run
    outs = {}

    def client(i, seed):
        outs[i] = batched.generate(1, seed=seed)

    threads = [threading.Thread(target=client, args=(i, s)) for i, s in ((0, 11), (1, 22))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert batched._batcher.batches_run == runs_before + 1  # merged into one call
    np.testing.assert_array_equal(_vol(outs[0]), solo)  # seed 11 alone or batched
    assert not np.array_equal(_vol(outs[1]), solo)


def test_ddpm_server_skips_micro_batcher_and_strides(files):
    """ddpm (ancestral) never micro-batches; its default is the full
    schedule, and a per-request step count strides it."""
    srv = ModelServer(*files, sampler="ddpm", steps=None, batch=2, device="cpu")
    srv.load_model()
    assert srv._batcher is None and srv.steps == 16
    out = srv.generate(1, seed=0, inference_steps=8)
    assert out["inference_steps"] == 8 and np.isfinite(_vol(out)).all()
    assert ("ddpm", 8, 1.0, None) in srv._sampler_cache
    np.testing.assert_array_equal(_vol(out), _vol(srv.generate(1, seed=0, inference_steps=8)))
    with pytest.raises(ValueError, match="num_inference_steps"):
        srv.generate(1, seed=0, inference_steps=17)


def test_per_request_options(real_api):
    srv = real_api.server
    body = {"num_samples": 1, "seed": 5, "inference_steps": 10, "guidance_scale": 2.0}
    code, payload, _ = real_api.dispatch("POST", "/generate", body)
    assert code == 200 and payload["inference_steps"] == 10 and payload["guidance_scale"] == 2.0
    n_variants = len(srv._sampler_cache)
    code, payload2, _ = real_api.dispatch("POST", "/generate", body)
    assert len(srv._sampler_cache) == n_variants  # the cached variant
    assert payload2["samples"][0]["data"] == payload["samples"][0]["data"]
    # a sampler override without steps takes that sampler's default (16 here)
    code, payload, _ = real_api.dispatch("POST", "/generate",
                                         {"num_samples": 1, "seed": 3, "sampler": "dpm3"})
    assert code == 200 and payload["sampler"] == "dpm3" and payload["inference_steps"] == 16
    assert ("dpm3", 16, 1.0, None) in srv._sampler_cache


def test_per_request_nii_output(real_api, tmp_path):
    from ldm3d_torch.utils.nifti import read_nifti

    code, payload, _ = real_api.dispatch("POST", "/generate",
                                         {"num_samples": 1, "seed": 1, "output_format": "nii"})
    assert code == 200
    sample = payload["samples"][0]
    assert sample["format"] == "nii"
    p = tmp_path / "out.nii"
    p.write_bytes(base64.b64decode(sample["data"]))
    vol, _ = read_nifti(str(p))
    assert list(vol.shape) == sample["shape"] and np.isfinite(vol).all()
    assert 0.0 <= float(vol.min()) and float(vol.max()) <= 1.0


def test_per_request_timestep_spacing(real_api):
    srv = real_api.server
    out = srv.generate(1, seed=4, sampler="dpm", inference_steps=6, timestep_spacing="karras")
    assert out["timestep_spacing"] == "karras"
    assert ("dpm", 6, 1.0, "karras") in srv._sampler_cache
    out2 = srv.generate(1, seed=4, sampler="dpm", inference_steps=6)
    assert out2["timestep_spacing"] == "leading"
    n = len(srv._sampler_cache)
    out3 = srv.generate(1, seed=4, sampler="dpm", inference_steps=6, timestep_spacing="leading")
    assert len(srv._sampler_cache) == n  # the server default's own variant
    assert out3["samples"][0]["data"] == out2["samples"][0]["data"]
    code, payload, _ = real_api.dispatch("POST", "/generate", {
        "num_samples": 1, "sampler": "ddpm", "timestep_spacing": "karras"})
    assert code == 422 and "ddpm" in payload["error"]
    code, payload, _ = real_api.dispatch("POST", "/generate", {
        "num_samples": 1, "sampler": "dpm", "inference_steps": 10, "timestep_spacing": "karras"})
    assert code == 422 and "karras" in payload["error"]


def test_server_default_timestep_spacing(files):
    srv = ModelServer(*files, sampler="dpm", steps=6, timestep_spacing="karras", device="cpu")
    srv.load_model()
    out = srv.generate(1, seed=0)
    assert out["timestep_spacing"] == "karras"
    n = len(srv._sampler_cache)
    same = srv.generate(1, seed=0, timestep_spacing="karras")
    assert len(srv._sampler_cache) == n
    assert same["samples"][0]["data"] == out["samples"][0]["data"]
    out2 = srv.generate(1, seed=0, timestep_spacing="trailing")
    assert out2["timestep_spacing"] == "trailing"
    assert out2["samples"][0]["data"] != out["samples"][0]["data"]
    with pytest.raises(ValueError, match="default spacing is karras"):
        srv.generate(1, seed=0, sampler="ddpm")
    out3 = srv.generate(1, seed=0, sampler="ddpm", timestep_spacing="leading")
    assert out3["sampler"] == "ddpm" and out3["timestep_spacing"] == "leading"


def test_variant_cache_stays_bounded(batched):
    """More (sampler, steps) variants than the cache holds: it stays bounded,
    the default stays pinned, and every variant serves."""
    cache_max = batched._sampler_cache_max
    variants = [("ddim", s) for s in (3, 4, 5, 6, 8)] + [("dpm", s) for s in (2, 3, 4, 5, 6)]
    assert len(variants) > cache_max
    for i, (sampler, steps) in enumerate(variants):
        out = batched.generate(1, seed=i, sampler=sampler, inference_steps=steps)
        assert np.isfinite(_vol(out)).all()
        assert len(batched._sampler_cache) <= cache_max
    assert ("ddim", 2, 1.0, None) in batched._sampler_cache
