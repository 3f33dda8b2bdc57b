"""The trainers' follow-ups in the port: preemption, ``--track``,
``--debug-nans``, ``--profile`` and ``device_prefetch``.

Mirrors the JAX package's ``tests/test_preemption.py``, ``tests/test_mlops.py``
(tracking and registry) and ``tests/test_obs.py`` (``Stopwatch``) case for
case, and holds the port to ``ldm3d_tpu``:

* a trainer stopped mid-epoch (``GracefulShutdown.trigger()`` on its third
  poll) exits 75 with a resumable ``last`` whose meta has the JAX trainer's
  keys, read from its source with ``ast`` (a JAX micro run of each takes
  minutes on the CPU), and values; a resume replays the epoch;
* ``track_run`` writes the JAX package's JSON tree, key for key;
* ``--debug-nans`` raises ``FloatingPointError`` on a NaN input in both
  packages, and the port's backward check raises at a NaN gradient;
* ``--profile`` writes a trace on the CPU and warns when the window never
  opens.
"""

import ast
import copy
import json
import logging
import os
import signal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ldm3d_torch.cli.train_autoencoder as port_ta
import ldm3d_torch.cli.train_diffusion as port_td
from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli import common as port_common
from ldm3d_torch.configs import define_instance
from ldm3d_torch.data import device_prefetch
from ldm3d_torch.mlops.tracking import ExperimentTracker, ModelRegistry, log_training_run
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.nn.blocks import ResBlock3D
from ldm3d_torch.obs import StepProfiler, Stopwatch
from ldm3d_torch.training import GracefulShutdown

torch.set_num_threads(1)

MICRO = os.path.join(os.path.dirname(port_common.__file__), "..", "configs", "presets",
                     "config_micro_cpu.json")


def _env(tmp_path, **overrides) -> str:
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
           "tfevent_path": str(tmp_path / "tb"), "seed": 0, "synthetic_data": True,
           "synthetic_num": 6, "synthetic_shape": [16, 16, 16], "resume_ckpt": False,
           "val_fraction": 0.34}
    env.update(overrides)
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


def _set_resume(env: str) -> None:
    data = json.loads(Path(env).read_text())
    data["resume_ckpt"] = True
    Path(env).write_text(json.dumps(data))


def _micro_cfg(tmp_path, warmup_epochs=None) -> str:
    cfg = json.loads(Path(MICRO).read_text())
    if warmup_epochs is not None:
        cfg["autoencoder_train"]["warmup_epochs"] = warmup_epochs
    path = tmp_path / "micro.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _jax_preempted_meta_keys(cli: str) -> set:
    """The keys of the meta the JAX trainer's ``main`` saves on preemption:
    the dict literal holding ``"preempted"``."""
    import ldm3d_tpu

    tree = ast.parse((Path(ldm3d_tpu.__file__).parent / "cli" / f"{cli}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    metas = [n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "preempted" for k in n.keys)]
    assert len(metas) == 1
    return {k.value for k in metas[0].keys}


class _StopOnThirdPoll(GracefulShutdown):
    """Triggers the shutdown on its third poll (mid-epoch 0)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.polls = 0

    @property
    def requested_global(self) -> bool:
        self.polls += 1
        if self.polls == 3:
            self.trigger()
        return self.requested


def test_sigterm_latches_flag():
    stop = GracefulShutdown()
    try:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)  # delivered on the main thread
        assert stop.requested and stop.requested_global
    finally:
        stop.restore()
    stop2 = GracefulShutdown()
    try:
        assert not stop2.requested
        stop2.trigger()
        assert stop2.requested
    finally:
        stop2.restore()


def test_requested_global_refuses_several_ranks(monkeypatch):
    """With several ranks the flag is no longer one process's: every read is
    a MAX all-reduce of the ranks' flags (one rank's latch stops all; the
    two-rank run is ``tests/test_torch_ddp.py``). Here the other rank is
    simulated: its flag enters the reduction."""
    stop = GracefulShutdown(signals=())
    other = {"flag": 0}
    calls = []

    def all_reduce(t, op=None):
        calls.append(op)
        t.copy_(torch.maximum(t, torch.full_like(t, other["flag"])))

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    assert not stop.requested_global
    other["flag"] = 1
    assert stop.requested_global and not stop.requested
    assert calls == [torch.distributed.ReduceOp.MAX] * 2


def test_stage1_trainer_preempt_saves_resumable_last(tmp_path, monkeypatch):
    """Stopped mid-epoch 0: exit 75 and a resumable 'last' with the JAX
    trainer's meta (epoch -1, best_val inf, preempted); the resumed run
    replays epoch 0 and completes it."""
    cfg, env = _micro_cfg(tmp_path), _env(tmp_path)
    monkeypatch.setattr(port_ta, "GracefulShutdown", _StopOnThirdPoll)
    timings = {}
    with pytest.raises(SystemExit) as exc:
        port_ta.main(["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "2",
                      "--no-images"], timings=timings)
    assert exc.value.code == 75
    assert len(timings["train_step_ms"]) == 2  # polls 1 and 2 ran a step; poll 3 stopped
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "autoencoder")
    meta = mgr.load_meta("last")
    assert set(meta) == _jax_preempted_meta_keys("train_autoencoder")
    assert meta == {"epoch": -1, "best_val": float("inf"), "preempted": True}
    last = mgr.load("last")
    assert set(last) == {"g", "d", "generator", "meta"}
    assert last["g"]["step"] == 2
    assert not mgr.exists("best")

    monkeypatch.setattr(port_ta, "GracefulShutdown", GracefulShutdown)
    _set_resume(env)
    timings = {}
    best = port_ta.main(["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "1",
                         "--no-images"], timings=timings)
    assert np.isfinite(best)
    assert len(timings["val_loss"]) == 1  # epoch 0 ran again, then validated
    assert mgr.load_meta("last")["epoch"] == 0
    assert mgr.load("last")["g"]["step"] == 2 + len(timings["train_step_ms"])
    assert mgr.exists("best")


def _stage1_best(tmp_path, cfg: str) -> None:
    args = SimpleNamespace(**json.loads(Path(cfg).read_text()))
    ae = init_weights_(define_instance(args, "autoencoder_def"),
                       torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "ckpt"), "autoencoder").save(
        "best", {"state_dict": ae.state_dict()})


def test_stage2_trainer_preempt_saves_resumable_last(tmp_path, monkeypatch):
    cfg, env = _micro_cfg(tmp_path), _env(tmp_path, synthetic_num=10, val_fraction=0.2)
    _stage1_best(tmp_path, cfg)
    monkeypatch.setattr(port_td, "GracefulShutdown", _StopOnThirdPoll)
    timings = {}
    with pytest.raises(SystemExit) as exc:
        port_td.main(["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "2",
                      "--no-images", "--ema-decay", "0.9"], timings=timings)
    assert exc.value.code == 75
    assert len(timings["train_step_ms"]) == 2
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "diffusion")
    meta = mgr.load_meta("last")
    assert set(meta) == _jax_preempted_meta_keys("train_diffusion")
    assert meta == {"epoch": -1, "best_val": float("inf"),
                    "scale_factor": timings["scale_factor"], "preempted": True}
    last = mgr.load("last")
    assert last["step"] == 2 and "ema_params" in last

    monkeypatch.setattr(port_td, "GracefulShutdown", GracefulShutdown)
    _set_resume(env)
    timings = {}
    best = port_td.main(["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "1",
                         "--no-images", "--ema-decay", "0.9"], timings=timings)
    assert np.isfinite(best)
    assert mgr.load_meta("last")["epoch"] == 0
    assert mgr.load("last")["step"] == 2 + len(timings["train_step_ms"])


def test_trainers_run_remat_grad_accum_and_track(tmp_path, monkeypatch):
    """Both trainers on the CPU with --remat convs / full, --grad-accum 2,
    --profile and --track: they finish, and each records its run."""
    monkeypatch.chdir(tmp_path)
    cfg, env = _micro_cfg(tmp_path, warmup_epochs=-1), _env(tmp_path, synthetic_num=10,
                                                            val_fraction=0.2)
    common = ["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "1", "--no-images",
              "--grad-accum", "2", "--track", "--experiment", "port-follow-ups", "--profile"]
    t1 = {}
    assert np.isfinite(port_ta.main([*common, "--remat", "convs"], timings=t1))
    assert all(t1["adv_active"])
    g_last = CheckpointManager(str(tmp_path / "ckpt"), "autoencoder").load("last")
    steps = len(t1["train_step_ms"])
    assert g_last["g"]["step"] == steps
    assert g_last["g"]["optimizer"]["accum"]["mini_step"] == steps % 2
    assert len(list((tmp_path / "profiler_logs").iterdir())) == 1
    t2 = {}
    assert np.isfinite(port_td.main([*common, "--remat"], timings=t2))
    runs = sorted((tmp_path / "mlruns_local" / "port-follow-ups").iterdir())
    stages = sorted(json.loads((r / "meta.json").read_text())["run_name"] for r in runs)
    assert stages == ["autoencoder", "diffusion"]


def _tree(root: Path) -> dict:
    """Every file of a tracked run: JSON content by relative path, with the
    run id and clock readings taken out."""
    out = {}
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(path.relative_to(root))
        text = path.read_text()
        if rel.endswith(".jsonl"):
            recs = [json.loads(line) for line in text.splitlines()]
            out[rel] = [{k: v for k, v in r.items() if k != "time"} for r in recs]
        else:
            rec = json.loads(text)
            out[rel] = ({k: v for k, v in rec.items()
                         if k not in ("run_id", "start_time", "end_time")}
                        if rel == "meta.json" else rec)
    return out


def test_track_run_writes_the_jax_tree(tmp_path, monkeypatch):
    """``track_run`` of both packages on the same arguments and the same
    stage metas: the same files with the same keys and values; only
    ``devices`` differs (the port runs on one device; JAX counts the test
    mesh's)."""
    from ldm3d_tpu.cli.common import track_run as jax_track_run
    from ldm3d_tpu.mlops import tracking as jax_tracking

    assert jax_tracking._mlflow() is None  # the JAX side takes its JSON fallback too
    meta = {"epoch": 3, "val_loss": 0.25, "best_val": 0.25}
    jax_dir, port_dir = tmp_path / "jax_models", tmp_path / "port_models"
    for sub in ("autoencoder", "discriminator"):
        (jax_dir / sub).mkdir(parents=True)
        (jax_dir / sub / "best_meta.json").write_text(json.dumps(meta))
    port_dir.mkdir()
    for name in ("autoencoder", "discriminator"):
        (port_dir / f"{name}_best_meta.json").write_text(json.dumps(meta))
    section = {"batch_size": 1, "lr": 1e-4, "patch_size": [16, 16, 16]}
    trees = {}
    for pkg, fn, model_dir in (("jax", jax_track_run, jax_dir),
                               ("port", port_common.track_run, port_dir)):
        monkeypatch.chdir(tmp_path)
        os.makedirs(pkg)
        monkeypatch.chdir(tmp_path / pkg)
        args = SimpleNamespace(track=True, experiment="exp", config_file="cfg.json", amp=True,
                               model_dir=str(model_dir), autoencoder_train=dict(section))
        fn(args, "autoencoder", {"best_val_recon_loss": 0.25})
        (run,) = (tmp_path / pkg / "mlruns_local" / "exp").iterdir()
        trees[pkg] = _tree(run)
    for tree in trees.values():
        tree["params.json"].pop("devices")
    assert trees["port"] == trees["jax"]
    assert set(trees["port"]) == {"meta.json", "params.json", "metrics.jsonl",
                                  "artifacts/autoencoder/best_meta.json",
                                  "artifacts/discriminator/best_meta.json"}


def test_tracker_local_fallback(tmp_path):
    tracker = ExperimentTracker("exp", tracking_root=str(tmp_path))
    run_id = tracker.start_run(run_name="r1", tags={"stage": "1"})
    tracker.log_params({"lr": 1e-4, "patch": [64, 64, 64]})
    tracker.log_metrics({"recon_loss": 0.5}, step=1)
    tracker.log_metrics({"recon_loss": 0.4}, step=2)
    tracker.end_run()
    run_dir = tmp_path / "exp" / run_id
    assert json.loads((run_dir / "meta.json").read_text())["status"] == "FINISHED"
    lines = (run_dir / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[1])["recon_loss"] == 0.4


def test_registry_promote_and_get(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.register("ldm", str(tmp_path), {"loss": 0.5})
    v2 = reg.register("ldm", str(tmp_path), {"loss": 0.4})
    assert (v1, v2) == (1, 2)
    reg.promote("ldm", 2, "Production")
    assert reg.get("ldm", "Production")["version"] == 2
    assert reg.get("ldm", "Staging") is None
    with pytest.raises(KeyError):
        reg.promote("ldm", 99, "Staging")
    with pytest.raises(ValueError):
        reg.promote("ldm", 1, "NotAStage")


def test_log_training_run(tmp_path):
    tracker = ExperimentTracker("exp", tracking_root=str(tmp_path))
    run_id = log_training_run(tracker, {"lr": 1}, {"val": 0.1})
    assert (tmp_path / "exp" / run_id / "params.json").exists()


def test_log_training_run_marks_a_failed_run(tmp_path):
    tracker = ExperimentTracker("exp", tracking_root=str(tmp_path))

    class Broken:
        def items(self):
            raise RuntimeError("bad params")

    with pytest.raises(RuntimeError):
        log_training_run(tracker, Broken(), {"val": 0.1})
    (run,) = (tmp_path / "exp").iterdir()
    assert json.loads((run / "meta.json").read_text())["status"] == "FAILED"


def test_debug_nans_raises_on_a_nan_input_in_both_packages(tmp_path, monkeypatch):
    """Each package's setup with ``--debug-nans``, then a ResBlock on a
    volume holding a NaN: ``FloatingPointError`` in both. The port names the
    first module whose output holds it; its backward check raises at a
    function that returns a NaN gradient. (The JAX setup keeps the suite's
    compile cache: it moves to ``~/.cache`` unless the variable names one.)"""
    import jax
    import jax.numpy as jnp

    from ldm3d_tpu.cli.common import build_parser as jax_build_parser
    from ldm3d_tpu.cli.common import setup as jax_setup
    from ldm3d_tpu.nn.blocks import ResBlock3D as JaxResBlock

    env = _env(tmp_path)
    x = np.random.default_rng(0).standard_normal((1, 4, 4, 4, 4)).astype(np.float32)
    x[0, 1, 2, 3, 0] = np.nan
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir or "")
    try:
        jax_setup(jax_build_parser("x").parse_args(["-c", MICRO, "-e", env, "--debug-nans"]))
        block = JaxResBlock(8, num_groups=2)
        params = block.init(jax.random.PRNGKey(0), jnp.zeros_like(x))
        assert jax.config.jax_debug_nans
        # a fresh jitted function: its first call takes JAX's checked path,
        # whatever eager ops of these shapes earlier tests in the process ran
        with pytest.raises(FloatingPointError):
            jax.jit(lambda p, v: block.apply(p, v))(params, jnp.asarray(x))
    finally:
        jax.config.update("jax_debug_nans", False)
        root.handlers[:], root.level = handlers, level

    args = port_common.build_parser("x").parse_args(["-c", MICRO, "-e", env, "--device", "cpu",
                                                     "--debug-nans"])
    try:
        port_common.setup(args)
        block = ResBlock3D(4, 8, 2)
        with pytest.raises(FloatingPointError, match="GroupNorm32"):
            block(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="returned nan"):
            (torch.sqrt(w) * 0).sum().backward()
    finally:
        port_common.disable_debug_nans()
    assert not torch.is_anomaly_enabled()
    block(torch.from_numpy(x).permute(0, 4, 1, 2, 3))  # the hook is gone


def test_cli_main_takes_debug_nans_off(tmp_path):
    """A CLI run with --debug-nans leaves neither the hook nor anomaly mode
    behind, also when it raises (here: no stage-1 checkpoint)."""
    env = _env(tmp_path)
    with pytest.raises(FileNotFoundError):
        port_td.main(["-c", MICRO, "-e", env, "--device", "cpu", "--debug-nans"])
    assert not torch.is_anomaly_enabled()
    assert not port_common._DEBUG_NANS


def _busy():
    a = torch.randn(64, 64)
    return (a @ a).sum()


def test_step_profiler_writes_a_trace(tmp_path):
    prof = StepProfiler(str(tmp_path / "logs"), enabled=True)
    for _ in range(6):
        _busy()
        prof.step()
    prof.stop()
    assert prof.trace_path is not None and os.path.dirname(prof.trace_path) == str(
        tmp_path / "logs")
    trace = json.loads(Path(prof.trace_path).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    assert len(list((tmp_path / "logs").iterdir())) == 1


def test_step_profiler_warns_when_the_window_never_opens(tmp_path):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("profiling")
    handler = Keep(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        prof = StepProfiler(str(tmp_path / "logs"), enabled=True)
        prof.step()
        prof.stop()
    finally:
        logger.removeHandler(handler)
    assert prof.trace_path is None and not (tmp_path / "logs").exists()
    assert any("produced no trace" in m for m in records)
    off = StepProfiler(str(tmp_path / "off"))
    for _ in range(6):
        off.step()
    off.stop()
    assert not (tmp_path / "off").exists()


def test_stopwatch():
    sw = Stopwatch()
    assert sw.lap() >= 0.0


def test_device_prefetch_keeps_order_and_places_on_the_device():
    batches = [{"image": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert [float(b["image"][0, 0]) for b in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["image"], torch.Tensor) for b in out)
    pulled = []

    def source():
        for b in copy.deepcopy(batches):
            pulled.append(1)
            yield b

    ahead = []
    for b in device_prefetch(source(), size=3, device="cpu"):
        ahead.append(len(pulled))
    # size batches in flight, and the next one pulled before each is handed on
    assert ahead == [4, 5, 5, 5, 5]
