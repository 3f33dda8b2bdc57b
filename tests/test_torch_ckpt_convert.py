"""``tools/jax_to_torch_ckpt.py``: the JAX package's orbax checkpoints and
LPIPS msgpack into the port's files.

Tiny JAX checkpoints of both stages on the micro preset, written by
``ldm3d_tpu.ckpt.CheckpointManager`` as the JAX trainers write them: params
of the Flax trees' shapes from numpy with a seed, and for ``last`` the
optimizer state after two optax updates on seeded gradients (so Adam's
moments and count are not their initial values), with an EMA for stage 2.
Held: the converted ``best`` models compute the JAX models' outputs (UNet
forward and VAE decode, 1e-4); ``last`` carries the params, the moments (by
name, through the bridge's layout rule, exactly), the count and the update
step, and a third update from the converted state equals optax's third
update (the port's ``ClippedAdam`` continues the JAX run, 1e-6 on the
params); the port's CLI samples from the converted ``model_dir``; an LPIPS
msgpack converts to a state_dict the port's trainer loads.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import ref_jit
from test_torch_stage1 import _fill, lpips_params

from ldm3d_torch.ckpt import CheckpointManager as PortManager
from ldm3d_torch.ckpt import lpips_state_dict_from_jax, state_dict_from_jax
from ldm3d_torch.configs import load_json, preset_path
from ldm3d_torch.training import TrainState, make_diffusion_optimizer, make_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import jax_to_torch_ckpt as tool  # noqa: E402

torch.set_num_threads(1)

LR = 1e-3


def _updates(params, tx, seed, n=2):
    """``n`` optax updates of ``params`` on seeded gradients; the state after."""
    rng = np.random.default_rng(seed)

    @ref_jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = ref_jit(tx.init)(params)
    for _ in range(n):
        grads = jax.tree_util.tree_map(
            lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
    return params, opt_state


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX model_dir with both stages' best/last (and stage 2's ema)."""
    from ldm3d_tpu.ckpt import CheckpointManager, StageArtifacts
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_diffusion_opt
    from ldm3d_tpu.training.stage1 import make_optimizer as jax_stage1_opt

    root = tmp_path_factory.mktemp("jax_run")
    cfg_path = preset_path("config_micro_cpu.json")
    cfg = load_json(cfg_path)
    shapes = tool._jax_models(cfg)
    params = {k: _fill(v, i + 1) for i, (k, v) in enumerate(shapes.items())}
    states = {}
    for stage, tx in (("autoencoder", jax_stage1_opt(lambda _: LR)),
                      ("discriminator", jax_stage1_opt(lambda _: LR)),
                      ("diffusion", jax_diffusion_opt(lambda _: LR))):
        p, opt_state = _updates(params[stage], tx, seed=len(stage))
        states[stage] = {"params": p, "opt_state": opt_state, "step": jnp.int32(2)}
    g = CheckpointManager(str(root), StageArtifacts.AUTOENCODER)
    g.save("best", {"params": params["autoencoder"]}, {"epoch": 3, "val_loss": 0.5})
    g.save("last", {"g": states["autoencoder"], "d": states["discriminator"]},
           {"epoch": 4, "val_loss": 0.6, "best_val": 0.5})
    CheckpointManager(str(root), StageArtifacts.DISCRIMINATOR).save(
        "best", {"params": params["discriminator"]}, {"epoch": 3})
    u = CheckpointManager(str(root), StageArtifacts.DIFFUSION)
    ema = jax.tree_util.tree_map(lambda a: 0.5 * a, params["diffusion"])
    u.save("best", {"params": params["diffusion"]}, {"epoch": 1, "scale_factor": 0.7})
    u.save("last", {**states["diffusion"], "ema_params": ema},
           {"epoch": 1, "val_loss": 0.9, "scale_factor": 0.7})
    u.save("ema", {"params": ema})
    return cfg_path, cfg, root, params, states, ema


@pytest.fixture(scope="module")
def converted(jax_run, tmp_path_factory):
    cfg_path, _, root, *_ = jax_run
    out = tmp_path_factory.mktemp("port_run")
    written = tool.main(["-c", cfg_path, "--jax-model-dir", str(root), "--out", str(out)])
    return out, written


def test_every_role_is_written_in_the_ports_layout(converted):
    out, written = converted
    names = sorted(os.path.basename(p) for p in written)
    assert names == sorted(["autoencoder_best.pt", "autoencoder_last.pt",
                            "discriminator_best.pt", "diffusion_best.pt", "diffusion_last.pt",
                            "diffusion_ema.pt"])
    assert PortManager(str(out), "diffusion").load_meta("best")["scale_factor"] == 0.7
    assert PortManager(str(out), "autoencoder").load("last")["meta"]["best_val"] == 0.5


def test_converted_best_models_compute_the_jax_outputs(jax_run, converted):
    from types import SimpleNamespace

    from ldm3d_torch.cli.common import load_two_stage
    from ldm3d_tpu.configs import ConfigResolver

    _, cfg, _, params, _, _ = jax_run
    out, _ = converted
    args = SimpleNamespace(**cfg, model_dir=str(out))
    ae, unet, latent, scale = load_two_stage(args, torch.device("cpu"), torch.float32)
    assert scale == 0.7
    r = ConfigResolver(cfg)
    jae, junet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *latent, junet.in_channels)).astype(np.float32)
    t = np.array([2, 9], np.int32)
    z = rng.standard_normal((1, *latent, cfg["latent_channels"])).astype(np.float32)

    @ref_jit
    def ref(u_p, a_p, x, t, z):
        return (junet.apply({"params": u_p}, x, t),
                jae.apply({"params": a_p}, z, method="decode_stage_2_outputs"))

    want_u, want_d = ref(params["diffusion"], params["autoencoder"], x, t, z)
    with torch.no_grad():
        got_u = unet(torch.from_numpy(x), torch.from_numpy(t))
        got_d = ae.decode_stage_2_outputs(torch.from_numpy(z))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4, rtol=0)


def _moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), adam.mu, adam.nu


@pytest.mark.parametrize("stage", ["autoencoder", "discriminator", "diffusion"])
def test_last_carries_moments_count_and_step_and_continues_the_jax_run(jax_run, converted,
                                                                       stage):
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_diffusion_opt
    from ldm3d_tpu.training.stage1 import make_optimizer as jax_stage1_opt

    _, cfg, _, _, states, ema = jax_run
    out, _ = converted
    model = tool._port_model(cfg, stage)
    if stage == "diffusion":
        last = PortManager(str(out), "diffusion").load("last")
        opt = make_diffusion_optimizer(model.parameters(), lambda _: LR)
        tx = jax_diffusion_opt(lambda _: LR)
        ema_want = state_dict_from_jax(jax.device_get(ema), model)
        assert all(torch.equal(last["ema_params"][k], v) for k, v in ema_want.items())
    else:
        last = PortManager(str(out), "autoencoder").load("last")["g" if stage == "autoencoder"
                                                                 else "d"]
        opt = make_optimizer(model.parameters(), lambda _: LR)
        tx = jax_stage1_opt(lambda _: LR)
    jstate = states[stage]
    count, mu, nu = _moments(jstate["opt_state"])
    assert last["step"] == 2 and count == 2
    state = TrainState(model, opt)
    state.load_state_dict(last)  # what --resume-ckpt does
    names = [n for n, _ in model.named_parameters()]
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        want = state_dict_from_jax(jax.device_get(tree), model)
        for i, name in enumerate(names):
            entry = last["optimizer"]["state"][i]
            assert float(entry["step"]) == 2.0
            assert torch.equal(entry[key], want[name]), (key, name)
    # a third update from the converted state equals optax's third update
    params = jax.device_get(jstate["params"])
    rng = np.random.default_rng(99)
    grads = jax.tree_util.tree_map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(
        np.float32), params)
    @ref_jit
    def third(grads, opt_state, params):
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates)

    want = state_dict_from_jax(jax.device_get(third(grads, jstate["opt_state"],
                                                    jstate["params"])), model)
    g = state_dict_from_jax(grads, model)
    for name, p in model.named_parameters():
        p.grad = g[name].clone()
    state.apply_gradients()
    worst = max((model.state_dict()[k] - v).abs().max().item() for k, v in want.items())
    assert worst <= 1e-6, worst


def test_the_ports_cli_samples_the_converted_model_dir(jax_run, converted, tmp_path):
    from ldm3d_torch.cli.inference import main as port_inference

    cfg_path = jax_run[0]
    out, _ = converted
    env = tmp_path / "env.json"
    env.write_text(json.dumps({"model_dir": str(out), "output_dir": str(tmp_path / "vols"),
                               "seed": 0, "synthetic_data": True, "synthetic_num": 2,
                               "synthetic_shape": [16, 16, 16]}))
    paths = port_inference(["-c", cfg_path, "-e", str(env), "--device", "cpu", "--sampler",
                            "ddim", "--steps", "2", "--use-ema"])
    assert len(paths) == 1 and os.path.exists(paths[0])


def test_lpips_msgpack_converts_to_a_state_dict_the_trainer_loads(tmp_path):
    from types import SimpleNamespace

    from flax import serialization

    from ldm3d_torch.cli.train_autoencoder import build_lpips
    from ldm3d_torch.nn import LPIPS

    params = lpips_params(seed=5)
    src = tmp_path / "lpips.msgpack"
    src.write_bytes(serialization.to_bytes({"params": params}))
    out = tmp_path / "lpips.pt"
    assert tool.main(["--lpips", str(src), "--lpips-out", str(out)]) == [str(out)]
    want = lpips_state_dict_from_jax(params, LPIPS())
    loaded = build_lpips(SimpleNamespace(lpips_weights=str(out)), torch.float32,
                         torch.device("cpu"))
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
