"""Parity of the port's models with the JAX package's at each new preset's shape.

``config_train_16g``, ``_multigpu`` and ``_stable`` with their widths
narrowed (channels and groups) and their structure kept, fp32 on the CPU,
the Flax params carried over by the weight bridge, outputs within 1e-4:

* 16g: a two-channel VAE and an unconditional UNet over an odd, non-cubic
  latent (12, 20, 28) -> (6, 10, 14) -> (3, 5, 7), attention at both lower
  levels over token counts that are not multiples of 64;
* multigpu: VAE attention at levels 1 and 2 and the decoder's non-local
  attention block;
* stable: one ResBlock a level, 16 VAE groups, UNet head width 32.

And 16g's two image channels against one-channel data: the JAX trainers
refuse the preset at their first encode (a 2-channel ``conv_in`` meeting a
1-channel crop) and the port's do too; unconditional sampling runs in both
and writes a two-channel volume.
"""

import copy
import json
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import ref_jit

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.ckpt.from_jax import autoencoder_state_dict_from_jax, unet_state_dict_from_jax
from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_autoencoder import main as port_train_ae
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import define_instance
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.utils.nifti import read_nifti
from ldm3d_tpu.configs import ConfigResolver, load_json, preset_path

ATOL = 1e-4

torch.set_num_threads(1)

# preset -> (autoencoder_def overrides, diffusion_def overrides, image shape of
# the VAE check, latent shape of the UNet check)
NARROWED = {
    "config_train_16g.json": (
        {"channels": [32, 32, 32]}, {"channels": [32, 32, 64], "num_head_channels": [0, 8, 8]},
        (16, 24, 32), (12, 20, 28)),
    "config_train_multigpu.json": (
        {"channels": [16, 16, 32], "norm_num_groups": 8},
        {"channels": [32, 32, 64], "num_head_channels": [0, 8, 8]}, (16, 16, 16), (8, 8, 8)),
    "config_train_stable.json": (
        {"channels": [16, 16, 32]}, {"channels": [32, 32, 64]}, (16, 16, 16), (12, 12, 12)),
}


def _narrowed(name: str) -> dict:
    cfg = copy.deepcopy(load_json(preset_path(name)))
    ae_kw, unet_kw = NARROWED[name][:2]
    cfg["autoencoder_def"].update(ae_kw)
    cfg["diffusion_def"].update(unet_kw)
    return cfg


def _pairs(cfg: dict, image, latent):
    r = ConfigResolver(cfg)
    jae, junet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    key = jax.random.PRNGKey(1)
    ae_params = jax.device_get(ref_jit(jae.init)(
        {"params": key, "sample": key}, jnp.zeros((1, *image, cfg["image_channels"])))["params"])
    u_params = jax.device_get(ref_jit(junet.init)(key, jnp.zeros((1, *latent, junet.in_channels)),
                                                  jnp.zeros((1,), jnp.int32))["params"])
    u_params["conv_out"]["kernel"] = 0.05 * np.random.default_rng(1).standard_normal(
        u_params["conv_out"]["kernel"].shape).astype(np.float32)
    ns = SimpleNamespace(**cfg)
    tae, tunet = define_instance(ns, "autoencoder_def"), define_instance(ns, "diffusion_def")
    tae.load_state_dict(autoencoder_state_dict_from_jax(ae_params, tae))
    tunet.load_state_dict(unet_state_dict_from_jax(u_params, tunet))
    return (jae, ae_params, tae.eval()), (junet, u_params, tunet.eval())


@pytest.mark.parametrize("name", sorted(NARROWED))
def test_narrowed_preset_models_match_jax(name):
    cfg = _narrowed(name)
    image, latent = NARROWED[name][2:]
    (jae, ae_params, tae), (junet, u_params, tunet) = _pairs(cfg, image, latent)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (1, *image, cfg["image_channels"])).astype(np.float32)
    jmu, _ = ref_jit(lambda p, v: jae.apply({"params": p}, v, method="encode"))(
        ae_params, jnp.asarray(x))
    jrecon = ref_jit(lambda p, v: jae.apply({"params": p}, v, method="decode_stage_2_outputs"))(
        ae_params, jmu)
    z = rng.standard_normal((2, *latent, junet.in_channels), dtype=np.float32)
    t = np.array([1, 900], np.int32)
    jeps = ref_jit(junet.apply)({"params": u_params}, jnp.asarray(z), jnp.asarray(t))
    with torch.no_grad():
        mu, _ = tae.encode(torch.from_numpy(x))
        recon = tae.decode_stage_2_outputs(torch.from_numpy(np.array(jmu)))
        eps = tunet(torch.from_numpy(z), torch.from_numpy(t))
    assert recon.shape[-1] == cfg["image_channels"] and eps.shape[-1] == junet.out_channels
    for got, want in ((mu, jmu), (recon, jrecon), (eps, jeps)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_16g_unet_sizes_at_the_odd_latent():
    """144 x 176 x 112 crops give a 36 x 44 x 28 latent: the stride-2 downs
    reach 9 x 11 x 7 and the upsamples come back to each skip's size."""
    cfg = load_json(preset_path("config_train_16g.json"))
    with torch.device("meta"):
        unet = define_instance(SimpleNamespace(**cfg), "diffusion_def")
        latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
        h = torch.zeros((1, 256, *latent))
        down = [tuple(h.shape[2:])]
        for name in ("down_0_downsample", "down_1_downsample"):
            h = getattr(unet, name)(h)
            down.append(tuple(h.shape[2:]))
        up = [tuple(h.shape[2:])]
        for name in ("up_2_upsample", "up_1_upsample"):
            h = getattr(unet, name)(torch.zeros((1, getattr(unet, name).conv.weight.shape[1],
                                                 *up[-1])))
            up.append(tuple(h.shape[2:]))
    assert down == [(36, 44, 28), (18, 22, 14), (9, 11, 7)]
    assert up == down[::-1]


def _small_16g(tmp_path) -> tuple:
    cfg = _narrowed("config_train_16g.json")
    for stage in ("autoencoder_train", "diffusion_train"):
        cfg[stage].update(batch_size=1, patch_size=[16, 16, 16], max_epochs=1, val_interval=1)
    path = tmp_path / "cfg16.json"
    path.write_text(json.dumps(cfg))
    env = tmp_path / "env.json"
    env.write_text(json.dumps({"model_dir": str(tmp_path / "m"), "output_dir": str(tmp_path / "o"),
                               "tfevent_path": str(tmp_path / "tb"), "seed": 0,
                               "synthetic_data": True, "synthetic_num": 4,
                               "synthetic_shape": [16, 16, 16]}))
    return cfg, str(path), str(env)


def test_16g_trainers_refuse_one_channel_data_as_jax(tmp_path):
    cfg, cfg_path, env = _small_16g(tmp_path)
    # JAX: params of the shapes init builds for 2 channels (their values do
    # not matter: the refusal is the shape check), then the first 1-channel crop
    jae = ConfigResolver(cfg).instantiate("autoencoder_def")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jae.init, {"params": key, "sample": key},
                            jnp.zeros((1, 16, 16, 16, 2)))["params"]
    params = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jae.apply({"params": params}, jnp.zeros((1, 16, 16, 16, 1)), method="encode")
    with pytest.raises(RuntimeError, match="to have 2 channels, but got 1"):
        port_train_ae(["-c", cfg_path, "-e", env, "--device", "cpu", "--no-images"])
    with torch.device("cpu"):
        ae = define_instance(SimpleNamespace(**cfg), "autoencoder_def")
    CheckpointManager(str(tmp_path / "m"), "autoencoder").save("best",
                                                              {"state_dict": ae.state_dict()})
    with pytest.raises(RuntimeError, match="to have 2 channels, but got 1"):
        port_train(["-c", cfg_path, "-e", env, "--device", "cpu", "--no-images",
                    "--unconditional"])


def test_16g_unconditional_sample_writes_two_channels(tmp_path):
    cfg, cfg_path, env = _small_16g(tmp_path)
    g = torch.Generator().manual_seed(0)
    ns = SimpleNamespace(**cfg)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), g)
    unet = init_weights_(define_instance(ns, "diffusion_def"), g)
    save_two_stage(str(tmp_path / "m"), ae, unet, 1.0)
    written = port_inference(["-c", cfg_path, "-e", env, "--device", "cpu", "--sampler", "ddim",
                              "--steps", "2"])
    vol, _ = read_nifti(written[0])
    assert vol.shape == (16, 16, 16, 2) and np.isfinite(vol).all()
