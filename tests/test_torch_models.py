"""Parity of the port's models, scheduler and weight bridge with the JAX package.

``DiffusionUNet3D`` and ``AutoencoderKL`` are built from the same preset in
both packages (the port resolves the presets' ``ldm3d_tpu.nn.*`` targets onto
its own modules), the Flax params reach the port through
``ldm3d_torch.ckpt.from_jax``, and both get the same numpy inputs. fp32 on
the CPU. Tolerances: 1e-4 for a model call (the blocks' bar, over a few
blocks of fp32 convs), 1e-6 relative for the scheduler's fp32 tables and
step arithmetic.
"""

import copy
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d_torch.ckpt.from_jax import (
    autoencoder_state_dict_from_jax,
    state_dict_from_jax,
    unet_state_dict_from_jax,
)
from ldm3d_torch.configs import define_instance as port_define_instance
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.diffusion import DDIMScheduler as PortDDIM
from ldm3d_tpu.configs import ConfigResolver, load_json, preset_path
from ldm3d_tpu.diffusion import DDIMScheduler as JaxDDIM

ATOL = 1e-4

# One intra-op thread in every test process that imports the port's tests:
# the suite runs in several worker processes at once, and torch's default of
# one thread per core in each of them oversubscribes the machine (the port's
# training tests ran 8x slower in the parallel suite than alone).
torch.set_num_threads(1)

# XLA's cheaper CPU codegen for the JAX reference programs of the port's
# tests (backend optimisation level 0, LLVM's expensive passes off): a cold
# compile of a model's init or train step takes about half the time. The
# programs compute the same functions; an initialiser's result may differ in
# its last bit, and both packages take the params the reference drew. Set on
# each jit: XLA_FLAGS would also reach the JAX package's own tests, which
# run in the same worker processes.
REF_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}


def ref_jit(fn, **kwargs):
    """``jax.jit`` of a JAX reference function under REF_COMPILER_OPTIONS.
    A function that is itself jitted (the JAX package's train steps) is
    traced into this one program."""
    return jax.jit(fn, compiler_options=REF_COMPILER_OPTIONS, **kwargs)


def jax_models(preset: str, seed: int = 0):
    """Flax AE + UNet of ``preset`` with initialised params; the UNet's
    zero-init ``conv_out`` gets seeded non-zero weights so that every layer
    reaches the output. Returns ``(cfg, ae, ae_params, unet, u_params)``.
    The inits run once a process for each (preset, seed); every caller gets
    its own copy of the config and the params."""
    cfg, ae, ae_params, unet, u_params = _jax_models(preset, seed)
    return copy.deepcopy(cfg), ae, copy.deepcopy(ae_params), unet, copy.deepcopy(u_params)


@functools.lru_cache(maxsize=None)
def _jax_models(preset: str, seed: int):
    cfg = load_json(preset_path(preset))
    r = ConfigResolver(cfg)
    ae, unet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    patch = cfg["diffusion_train"]["patch_size"]
    latent = [p // ae.downsample_factor for p in patch]
    key = jax.random.PRNGKey(seed)
    ae_params = ref_jit(ae.init)({"params": key, "sample": key},
                                 jnp.zeros((1, *patch, cfg["image_channels"])))["params"]
    u_params = ref_jit(unet.init)(key, jnp.zeros((1, *latent, unet.in_channels)),
                                  jnp.zeros((1,), jnp.int32))["params"]
    u_params = jax.device_get(u_params)
    rng = np.random.default_rng(seed)
    kernel = u_params["conv_out"]["kernel"]
    u_params["conv_out"]["kernel"] = 0.05 * rng.standard_normal(kernel.shape).astype(np.float32)
    return cfg, ae, jax.device_get(ae_params), unet, u_params


def port_models(cfg, ae_params, u_params):
    """The port's AE + UNet of ``cfg`` carrying the Flax params."""
    ns = SimpleNamespace(**cfg)
    ae = port_define_instance(ns, "autoencoder_def")
    unet = port_define_instance(ns, "diffusion_def")
    ae.load_state_dict(autoencoder_state_dict_from_jax(ae_params, ae))
    unet.load_state_dict(unet_state_dict_from_jax(u_params, unet))
    return ae.eval(), unet.eval()


@pytest.fixture(scope="module")
def micro():
    cfg, jae, ae_params, junet, u_params = jax_models("config_micro_cpu.json")
    tae, tunet = port_models(cfg, ae_params, u_params)
    return cfg, jae, ae_params, junet, u_params, tae, tunet


def test_port_presets_are_the_jax_presets():
    """All eight of the JAX package's preset files, byte for byte."""
    import os

    from ldm3d_tpu.configs import PRESET_DIR

    names = sorted(os.listdir(PRESET_DIR))
    assert len(names) == 8 and sorted(os.listdir(os.path.dirname(port_preset_path("x")))) == names
    for name in names:
        with open(port_preset_path(name), "rb") as a, open(preset_path(name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("preset", ["config_micro_cpu.json", "config_tiny_cpu.json"])
def test_unet_forward_matches_jax(preset, micro):
    if preset == "config_micro_cpu.json":
        cfg, _, _, junet, u_params, _, tunet = micro
    else:
        cfg, _, ae_params, junet, u_params = jax_models(preset, seed=1)
        tunet = port_models(cfg, ae_params, u_params)[1]
    latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *latent, junet.in_channels), dtype=np.float32)
    t = np.array([3, 11], np.int32)
    ref = np.asarray(ref_jit(junet.apply)({"params": u_params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_autoencoder_matches_jax(micro):
    cfg, jae, ae_params, _, _, tae, _ = micro
    patch = cfg["diffusion_train"]["patch_size"]
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, *patch, 1)).astype(np.float32)
    jmu, jsigma = ref_jit(lambda p, v: jae.apply({"params": p}, v, method="encode"))(
        ae_params, jnp.asarray(x))
    eps = rng.standard_normal(jmu.shape, dtype=np.float32)
    with torch.no_grad():
        mu, sigma = tae.encode(torch.from_numpy(x))
        z = tae.encode_stage_2_inputs(torch.from_numpy(x), torch.from_numpy(eps))
        recon = tae.decode(z).numpy()
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), atol=ATOL, rtol=0)
    ref_z = np.asarray(jmu + jsigma * jnp.asarray(eps))
    np.testing.assert_allclose(z.numpy(), ref_z, atol=ATOL, rtol=0)
    ref_recon = np.asarray(ref_jit(
        lambda p, z: jae.apply({"params": p}, z, method="decode_stage_2_outputs"))(
        ae_params, jnp.asarray(ref_z)))
    assert recon.shape == x.shape
    np.testing.assert_allclose(recon, ref_recon, atol=ATOL, rtol=0)


@pytest.mark.parametrize("spacing,steps,n_train", [("leading", 50, 1000), ("trailing", 4, 16),
                                                    ("leading", 3, 16)])
def test_ddim_tables_and_step_match_jax(spacing, steps, n_train):
    kw = dict(num_train_timesteps=n_train, num_inference_steps=steps, timestep_spacing=spacing)
    js, ts = JaxDDIM.create(**kw), PortDDIM.create(**kw)
    np.testing.assert_allclose(ts.betas.numpy(), np.asarray(js.betas), rtol=1e-6)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod), rtol=1e-6)
    assert ts.timesteps == [int(t) for t in np.asarray(js.timesteps)]
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((1, 3, 3, 3, 2), dtype=np.float32)
    pred = rng.standard_normal((1, 3, 3, 3, 2), dtype=np.float32)
    for t in ts.timesteps:
        ref = np.asarray(js.step(jnp.asarray(pred), jnp.int32(t), jnp.asarray(x),
                                 jax.random.PRNGKey(0)))
        out = ts.step(torch.from_numpy(pred), t, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_ddim_rejects_what_is_not_ported():
    """DDIM takes eta > 0 now; it rejects, as the JAX scheduler does, the
    karras spacing (a grid, for GridDDIM) and a trailing grid that does not
    divide the schedule."""
    sched = PortDDIM.create(eta=0.5)
    assert sched.eta == 0.5 and JaxDDIM.create(eta=0.5).eta == 0.5
    for cls in (PortDDIM, JaxDDIM):
        with pytest.raises(ValueError, match="karras"):
            cls.create(timestep_spacing="karras")
        with pytest.raises(ValueError, match="trailing"):
            cls.create(num_train_timesteps=16, num_inference_steps=5, timestep_spacing="trailing")


def test_bridge_consumes_every_leaf_and_fills_every_parameter(micro):
    _, _, ae_params, _, u_params, tae, tunet = micro
    for params, model in ((ae_params, tae), (u_params, tunet)):
        sd = state_dict_from_jax(params, model)
        assert set(sd) == set(model.state_dict())
        n_leaves = len(jax.tree_util.tree_leaves(params))
        assert len(sd) == n_leaves

    extra = dict(u_params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unconsumed.*stray"):
        state_dict_from_jax(extra, tunet)
    missing = {k: v for k, v in u_params.items() if k != "mid_attn"}
    with pytest.raises(ValueError, match="unfilled.*mid_attn"):
        state_dict_from_jax(missing, tunet)
    wrong = dict(u_params, conv_in={"kernel": np.zeros((3, 3, 3, 1, 1), np.float32),
                                    "bias": u_params["conv_in"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(wrong, tunet)
