"""The port's mlops tools against the JAX package's, on the CPU.

Monitoring: ``DriftDetector`` and ``ModelMonitoring`` give the JAX numbers
on seeded arrays (rtol 1e-12; the port's KS p-value is the JAX module's
numpy path, which it takes without scipy). Deployment: the rendered
manifests are the JAX ones but for the container (the port's server on one
NVIDIA GPU), and apply/rollout run against a fake ``kubectl``. Workspace:
the create/verify/dry-run flow against a fake ``gcloud``, with an H100 node
pool. Pipelines: the cloud specs name the port, and ``run_local`` trains,
evaluates (the sampled path) and registers at ``config_micro_cpu.json``.
"""

import builtins
import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from ldm3d_torch.cli import common as port_common
from ldm3d_torch.mlops.deployment import DeployError, ModelDeployment
from ldm3d_torch.mlops.deployment.deploy_model import main as deploy_main
from ldm3d_torch.mlops.monitoring import DriftDetector, ModelMonitoring
from ldm3d_torch.mlops.pipelines import BatchInferencePipeline, TrainingPipeline
from ldm3d_torch.mlops.tracking import ModelRegistry
from ldm3d_torch.mlops.workspace import WorkspaceConfig, WorkspaceError, WorkspaceSetup
from ldm3d_torch.mlops.workspace import main as ws_main
from ldm3d_tpu.mlops.deployment import ModelDeployment as JaxDeployment
from ldm3d_tpu.mlops.monitoring import DriftDetector as JaxDrift
from ldm3d_tpu.mlops.monitoring import ModelMonitoring as JaxMonitoring
from ldm3d_tpu.mlops.pipelines import TrainingPipeline as JaxPipeline

torch.set_num_threads(1)

RTOL = 1e-12
MICRO = os.path.join(os.path.dirname(port_common.__file__), "..", "configs", "presets",
                     "config_micro_cpu.json")


@pytest.fixture
def no_scipy(monkeypatch):
    """The JAX detector's KS test without scipy: its numpy path."""
    real_import = builtins.__import__

    def refuse(name, *a, **k):
        if name == "scipy" or name.startswith("scipy."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", refuse)


def _samples(seed):
    rng = np.random.default_rng(seed)
    return {"same": (rng.normal(0, 1, 500), rng.normal(0, 1, 700)),
            "shift": (rng.normal(0, 1, 800), rng.normal(0.4, 1.2, 600)),
            "far": (rng.exponential(2.0, 300), rng.normal(5, 1, 300))}


def _close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("bins", [10, 7])
def test_drift_numbers_are_jax(no_scipy, bins):
    port, jax_det = DriftDetector(psi_bins=bins), JaxDrift(psi_bins=bins)
    for name, (ref, cur) in _samples(bins).items():
        _close(port.check_feature(name, ref, cur), jax_det.check_feature(name, ref, cur))
        np.testing.assert_allclose(port.psi(ref, cur), jax_det.psi(ref, cur), rtol=RTOL)
    for psi in (0.05, 0.1, 0.15, 0.2, 3.0):
        assert DriftDetector.severity(psi) == JaxDrift.severity(psi)


def test_ks_statistic_and_psi_are_jaxs_scipy_path():
    """With scipy, the JAX detector's statistic and PSI are the port's too."""
    port, jax_det = DriftDetector(), JaxDrift()
    for name, (ref, cur) in _samples(1).items():
        got, want = port.check_feature(name, ref, cur), jax_det.check_feature(name, ref, cur)
        np.testing.assert_allclose(got["ks_statistic"], want["ks_statistic"], rtol=RTOL)
        np.testing.assert_allclose(got["psi"], want["psi"], rtol=RTOL)
        assert got["psi_severity"] == want["psi_severity"]


def test_monitoring_reports_are_jax(tmp_path, no_scipy):
    alerts_p, alerts_j = [], []
    port = ModelMonitoring(str(tmp_path / "p"), thresholds={"min_throughput_rps": 1.0},
                           alert_fn=lambda k, p: alerts_p.append(k))
    jax_mon = JaxMonitoring(str(tmp_path / "j"), thresholds={"min_throughput_rps": 1.0},
                            alert_fn=lambda k, p: alerts_j.append(k))
    s = _samples(3)
    ref = {k: v[0] for k, v in s.items()}
    cur = {k: v[1] for k, v in s.items()}
    got, want = port.check_data_drift(ref, cur), jax_mon.check_data_drift(ref, cur)
    assert got["num_drifted"] == want["num_drifted"] and got["drift_detected"]
    for g, w in zip(got["features"], want["features"]):
        _close(g, w)
    for metrics in ({"latency_ms": 20000, "error_rate": 0.2, "throughput_rps": 0.5},
                    {"latency_ms": 100, "error_rate": 0.0, "throughput_rps": 3.0}):
        g, w = port.check_performance(metrics), jax_mon.check_performance(metrics)
        assert (g["alerts"], g["healthy"]) == (w["alerts"], w["healthy"])
    assert alerts_p == alerts_j == ["data_drift", "performance"]
    path = port.generate_report(got, None)
    assert json.loads(open(path).read())["drift"]["num_drifted"] == got["num_drifted"]


def _jax_container_as_port(manifest: dict) -> dict:
    """The JAX manifest with the port's container and node selection."""
    out = copy.deepcopy(manifest)
    spec = out["spec"]["template"]["spec"]
    c = spec["containers"][0]
    c["args"] = ["python", "-m", "ldm3d_torch.serving.api_server", "--port", "8000"]
    c["resources"]["limits"] = {"nvidia.com/gpu": "1"}
    spec["nodeSelector"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    return out


@pytest.mark.parametrize("traffic", [100, 30, 0])
def test_render_is_the_jax_manifest_on_a_gpu(tmp_path, traffic):
    port = ModelDeployment(out_dir=str(tmp_path / "p"), namespace="ns")
    jax_dep = JaxDeployment(out_dir=str(tmp_path / "j"), namespace="ns")
    got = port.render("ldm3d", 3, "img:1", traffic, model_dir="/m", replicas=4)
    want = jax_dep.render("ldm3d", 3, "img:1", traffic, model_dir="/m", replicas=4)
    assert got["service"] == want["service"]
    assert got["deployment"] == _jax_container_as_port(want["deployment"])
    container = got["deployment"]["spec"]["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert "ldm3d_torch.serving.api_server" in container["args"]
    paths = port.write_manifests(got, "ldm3d_v3")
    assert [yaml.safe_load(open(p)) for p in paths] == [got["deployment"], got["service"]]


def test_deploy_from_the_registry(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.register("ldm3d", str(tmp_path / "ckpt"), {"loss": 0.2})
    reg.promote("ldm3d", 1, "Production")
    result = ModelDeployment(registry=reg, out_dir=str(tmp_path / "out")).deploy(
        "ldm3d", image="ldm3d-torch:v1")
    assert result["version"] == 1 and not result["applied"]
    manifest = yaml.safe_load(open(result["manifests"][0]))
    env = manifest["spec"]["template"]["spec"]["containers"][0]["env"]
    assert {"name": "MODEL_DIR", "value": str(tmp_path / "ckpt")} in env
    with pytest.raises(DeployError, match="no model named"):
        ModelDeployment(registry=reg, out_dir=str(tmp_path / "out")).deploy(
            "ldm3d", image="i", stage="Staging")


def _fake_tool(tmp_path, name, fail_if):
    """A fake CLI that appends its argv to a log and fails when ``fail_if``
    (a shell condition on "$@") holds."""
    log = tmp_path / f"{name}_calls.log"
    script = tmp_path / name
    script.write_text("#!/bin/sh\n"
                      f'echo "$@" >> "{log}"\n'
                      f"if {fail_if}; then echo boom >&2; exit 1; fi\n"
                      "exit 0\n")
    script.chmod(0o755)
    return str(script), log


def test_apply_and_rollout_through_kubectl(tmp_path):
    kubectl, calls = _fake_tool(tmp_path, "kubectl", "false")
    result = ModelDeployment(out_dir=str(tmp_path / "out"), kubectl=kubectl).deploy(
        "ldm3d", image="ldm3d-torch:v1", apply=True)
    assert result["applied"] is True
    lines = calls.read_text().splitlines()
    assert [l for l in lines if l.startswith("apply -f ")] == \
        [f"apply -f {p}" for p in result["manifests"]]
    assert any(l.startswith("rollout status deployment/ldm3d-v1 -n ldm3d --timeout=600s")
               for l in lines)


def test_apply_failures_raise(tmp_path):
    kubectl, _ = _fake_tool(tmp_path, "kubectl", '[ "$1" = rollout ]')
    with pytest.raises(DeployError, match="rollout"):
        ModelDeployment(out_dir=str(tmp_path / "out"), kubectl=kubectl).deploy(
            "ldm3d", image="i", apply=True)
    with pytest.raises(DeployError, match="not on PATH"):
        ModelDeployment(out_dir=str(tmp_path / "out"), kubectl="no-such-kubectl").deploy(
            "ldm3d", image="i", apply=True)
    result = deploy_main(["--image", "ldm3d-torch:v2", "--out-dir", str(tmp_path / "o")])
    assert result["applied"] is False and all(os.path.exists(p) for p in result["manifests"])


def test_workspace_creates_what_is_missing(tmp_path):
    missing = ("ldm3d-cluster", "gpu-train-pool", "cpu-serve-pool")
    gcloud, calls = _fake_tool(tmp_path, "gcloud", " || ".join(
        f'echo "$@" | grep -q "describe {m}"' for m in missing))
    report = WorkspaceSetup(WorkspaceConfig(project="p"), gcloud=gcloud).setup()
    lines = calls.read_text()
    assert "clusters create ldm3d-cluster" in lines
    assert ("node-pools create gpu-train-pool --cluster ldm3d-cluster --region us-central1 "
            "--machine-type a3-highgpu-1g --accelerator "
            "type=nvidia-h100-80gb,count=1,gpu-driver-version=default --num-nodes 1 --spot "
            "--project p") in lines
    assert "node-pools create cpu-serve-pool" in lines
    assert report == {"cluster": "missing", "gpu_pool": "missing", "cpu_pool": "missing",
                      "ready": False}


def test_workspace_is_idempotent_and_dry_runs(tmp_path, capsys):
    gcloud, calls = _fake_tool(tmp_path, "gcloud", "false")
    report = WorkspaceSetup(WorkspaceConfig(project="p"), gcloud=gcloud).setup()
    assert "create" not in calls.read_text()
    assert report == {"cluster": "ok", "gpu_pool": "ok", "cpu_pool": "ok", "ready": True}
    report = ws_main(["--project", "demo", "--dry-run", "--gpu-count", "8"])
    out = capsys.readouterr().out
    assert "clusters create ldm3d-cluster" in out
    assert "--machine-type a3-highgpu-8g --accelerator type=nvidia-h100-80gb,count=8" in out
    assert report["ready"] is True
    with pytest.raises(WorkspaceError, match="not on PATH"):
        WorkspaceSetup(WorkspaceConfig(project="p"), gcloud="no-such-gcloud").setup()


def test_cloud_specs_name_the_port(tmp_path):
    got = TrainingPipeline("cfg.json", "env.json", str(tmp_path)).emit_cloud_spec(image="img:1")
    want = JaxPipeline("cfg.json", "env.json", str(tmp_path)).emit_cloud_spec(image="img:1")
    assert [s["name"] for s in got["steps"]] == [s["name"] for s in want["steps"]]
    for g, w in zip(got["steps"], want["steps"]):
        assert g["command"] == w["command"].replace("ldm3d_tpu", "ldm3d_torch")
        assert g.get("depends_on") == w.get("depends_on")
        assert g["accelerator"] in (None, "nvidia-h100-80gb")
    spec = BatchInferencePipeline("cfg.json", "env.json", num_samples=16, sampler="dpm",
                                  steps=20, batch=4).emit_cloud_spec()
    cmd = spec["steps"][0]["command"]
    assert cmd.startswith("python -m ldm3d_torch.cli.inference") and "--num 4 --batch 4" in cmd
    auto = BatchInferencePipeline("cfg.json", "env.json", num_samples=5)
    assert auto._batch() == max(1, min(5, 8 * max(1, torch.cuda.device_count())))


def test_run_local_trains_evaluates_and_registers(tmp_path):
    env = tmp_path / "env.json"
    env.write_text(json.dumps({
        "model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
        "tfevent_path": str(tmp_path / "tb"), "seed": 0, "synthetic_num": 6,
        "synthetic_shape": [16, 16, 16], "resume_ckpt": False, "val_fraction": 0.34}))
    reg = ModelRegistry(str(tmp_path / "reg"))
    pipe = TrainingPipeline(MICRO, str(env), str(tmp_path / "ckpt"), eval_threshold=0.0,
                            registry=reg, max_epochs=1,
                            extra_flags=["--synthetic-data", "--device", "cpu", "--no-images"])
    results = pipe.run_local()
    assert results["data_prep"] == {"train_samples": 4, "val_samples": 2}
    assert np.isfinite(results["autoencoder"]["best_val_recon_loss"])
    assert np.isfinite(results["diffusion"]["best_val_diffusion_loss"])
    evaluation = results["evaluation"]
    assert "ssim" in evaluation and np.isfinite(evaluation["score"])  # the sampled path
    assert evaluation["passed"] is True and results["registered_version"] == 1
    assert reg.get("ldm3d-torch", "None")["checkpoint_dir"] == str(tmp_path / "ckpt")
    assert os.path.exists(tmp_path / "ckpt" / "evaluation_report.json")
