"""Parity of the port's reference-checkpoint import and export with the JAX package.

The reference-layout ``.pt`` files here are what the JAX package's
``export_torch_state_dict`` writes from Flax params (MONAI is not
installed): split (MONAI 1.3 ``to_q/to_k/to_v``) and fused (SABlock ``qkv``)
attention, with and without DDP's ``module.`` prefix and the buffers torch
saves beside the parameters. The port holds itself to that layout:

* each file imports into the port's autoencoder, UNet and discriminator
  bit-equal to the weights the Flax->port bridge gives, and the models'
  outputs equal the JAX models' within 1e-4 (fp32, the CPU);
* the port's export equals JAX's tensor for tensor: order, shape and bits;
* a wrong shape, a leftover tensor and an unfilled parameter (the
  ``mid_depth`` stack, as in JAX) raise ``ImportMismatchError`` with context;
* ``cli.import_checkpoint`` then ``cli.inference --device cpu`` on the tiny
  preset gives JAX's sample within 1e-4; the import and export CLIs' flags
  and refusals.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_models, port_models, ref_jit
from test_torch_sample import SCALE_FACTOR, _env, _jax_sample

from ldm3d_torch.ckpt import CheckpointManager, state_dict_from_jax
from ldm3d_torch.ckpt import import_torch as P
from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.cli.export_checkpoint import main as port_export
from ldm3d_torch.cli.import_checkpoint import main as port_import
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.configs import define_instance, load_json
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.configs.resolver import ConfigResolutionError
from ldm3d_torch.nn import DiffusionUNet3D
from ldm3d_torch.nn import PatchDiscriminator3D as PortDisc
from ldm3d_torch.utils.nifti import read_nifti
from ldm3d_tpu.ckpt import import_torch as J
from ldm3d_tpu.nn import PatchDiscriminator3D as JaxDisc
from ldm3d_tpu.nn.diffusion_unet import DiffusionUNet3D as JaxUNet

ATOL = 1e-4
TINY = "config_tiny_cpu.json"
MID_KW = dict(in_channels=4, out_channels=2, channels=(8, 16), attention_levels=(False, True),
              num_head_channels=(0, 8), num_res_blocks=(1, 1), norm_num_groups=4)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg, jae, ae_params, junet, u_params = jax_models(TINY, seed=3)
    tae, tunet = port_models(cfg, ae_params, u_params)
    jd = JaxDisc(num_layers_d=3, channels=4, in_channels=1)
    d_params = jax.device_get(ref_jit(jd.init)(jax.random.PRNGKey(2),
                                               jnp.zeros((1, 16, 16, 16, 1)))["params"])
    td = PortDisc(num_layers_d=3, channels=4, in_channels=1)
    td.load_state_dict(state_dict_from_jax(d_params, td))
    return {"cfg": cfg,
            "autoencoder": (jae, ae_params, tae, J.autoencoder_manifest, P.autoencoder_manifest),
            "unet": (junet, u_params, tunet, J.unet_manifest, P.unet_manifest),
            "discriminator": (jd, d_params, td, J.sequential_manifest, P.sequential_manifest)}


def _reference_file(jax_manifest, params, qkv_mode: str, ddp: bool) -> dict:
    """A reference-layout state_dict as torch saves it: the JAX export's
    tensors, optionally under ``module.`` with a BatchNorm's buffers."""
    sd = J.export_torch_state_dict(jax_manifest(params), params, qkv_mode)
    out = {}
    for i, (k, v) in enumerate(sd.items()):
        out[("module." if ddp else "") + k] = torch.from_numpy(np.ascontiguousarray(v))
        if ddp and i == 3:
            for buf, val in (("running_mean", torch.zeros(2)), ("running_var", torch.ones(2)),
                             ("num_batches_tracked", torch.tensor(7))):
                out[f"module.bn.{buf}"] = val
    return out


def _import(model: torch.nn.Module, manifest_fn, sd: dict) -> dict:
    items = P.flatten_torch_state_dict(sd)
    return P.assigned_to_state_dict(model.state_dict(), P.match_state_dict(manifest_fn(model),
                                                                            items))


def _outputs(name, tiny, port_model, params):
    """The JAX model's and the port model's outputs on seeded inputs."""
    jmodel = tiny[name][0]
    cfg = tiny["cfg"]
    rng = np.random.default_rng(11)
    if name == "unet":
        latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
        x = rng.standard_normal((2, *latent, jmodel.in_channels), dtype=np.float32)
        t = np.array([2, 9], np.int32)
        ref = ref_jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            out = port_model(torch.from_numpy(x), torch.from_numpy(t))
        return np.asarray(ref), out.numpy()
    x = rng.uniform(0, 1, (1, 16, 16, 16, 1)).astype(np.float32)
    if name == "autoencoder":
        ref = ref_jit(lambda v, a: jmodel.apply(v, a, method="encode"))(
            {"params": params}, jnp.asarray(x))[0]
        with torch.no_grad():
            out = port_model.encode(torch.from_numpy(x))[0]
        return np.asarray(ref), out.numpy()
    ref = ref_jit(jmodel.apply)({"params": params}, jnp.asarray(x))[-1]
    with torch.no_grad():
        out = port_model(torch.from_numpy(x))[-1]
    return np.asarray(ref), out.numpy()


CASES = [(m, q, d) for m in ("autoencoder", "unet") for q in ("split", "fused")
         for d in (False, True)] + [("discriminator", "split", d) for d in (False, True)]


@pytest.mark.parametrize("name,qkv_mode,ddp", CASES,
                         ids=[f"{m}-{q}-{'ddp' if d else 'plain'}" for m, q, d in CASES])
def test_reference_file_imports_bit_equal_and_matches_jax(tiny, name, qkv_mode, ddp):
    _, params, bridged, jax_manifest, port_manifest = tiny[name]
    sd = _import(bridged, port_manifest, _reference_file(jax_manifest, params, qkv_mode, ddp))
    want = bridged.state_dict()
    assert list(sd) == list(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    key = {"autoencoder": "autoencoder_def", "unet": "diffusion_def"}.get(name)
    fresh = (define_instance(SimpleNamespace(**tiny["cfg"]), key) if key
             else PortDisc(num_layers_d=3, channels=4))
    fresh.load_state_dict(sd)
    ref, out = _outputs(name, tiny, fresh.eval(), params)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _assert_same_export(jax_sd, port_sd):
    assert len(jax_sd) == len(port_sd)
    for (jk, jv), (pk, pv) in zip(jax_sd.items(), port_sd.items()):
        assert pv.dtype == torch.float32 and tuple(pv.shape) == jv.shape, (jk, pk)
        np.testing.assert_array_equal(pv.numpy(), jv, err_msg=f"{jk} / {pk}")


EXPORTS = [("autoencoder", "split"), ("autoencoder", "fused"), ("unet", "split"),
           ("unet", "fused"), ("discriminator", "split")]


@pytest.mark.parametrize("name,qkv_mode", EXPORTS, ids=[f"{m}-{q}" for m, q in EXPORTS])
def test_port_export_is_the_jax_export(tiny, name, qkv_mode):
    _, params, bridged, jax_manifest, port_manifest = tiny[name]
    _assert_same_export(J.export_torch_state_dict(jax_manifest(params), params, qkv_mode),
                        P.export_torch_state_dict(port_manifest(bridged), bridged, qkv_mode))


def _mid_depth_pair(depth: int = 2):
    junet = JaxUNet(**MID_KW, mid_depth=depth)
    params = jax.device_get(ref_jit(junet.init)(jax.random.PRNGKey(4), jnp.zeros((1, 4, 4, 4, 4)),
                                                jnp.zeros((1,), jnp.int32))["params"])
    tunet = DiffusionUNet3D(**MID_KW, mid_depth=depth)
    tunet.load_state_dict(state_dict_from_jax(params, tunet))
    return params, tunet


def test_mid_depth_unet_exports_and_refuses_the_import_as_jax():
    """The ``mid_depth`` stack has no reference counterpart: JAX's manifest
    leaves it out, so its export carries none of it and its import stops
    at the first stack leaf no tensor filled. The port does the same."""
    params, tunet = _mid_depth_pair()
    jax_sd = J.export_torch_state_dict(J.unet_manifest(params), params, "split")
    _assert_same_export(jax_sd, P.export_torch_state_dict(P.unet_manifest(tunet), tunet))
    items = [(k, np.asarray(v)) for k, v in jax_sd.items()]
    with pytest.raises(J.ImportMismatchError, match="no torch tensor assigned for .*mid_stack"):
        J.assigned_to_tree(params, J.match_state_dict(J.unet_manifest(params), items))
    with pytest.raises(P.ImportMismatchError, match=r"no torch tensor assigned for mid_stack\.0"):
        _import(tunet, P.unet_manifest, {k: torch.from_numpy(v) for k, v in jax_sd.items()})


def test_manifests_cover_every_parameter_with_nonlocal_attention():
    from ldm3d_torch.nn import AutoencoderKL

    ae = AutoencoderKL(in_channels=1, latent_channels=3, channels=(4, 8), num_res_blocks=(1, 1),
                       attention_levels=(False, True), norm_num_groups=2,
                       with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True)
    paths = [e.path for e in P.autoencoder_manifest(ae)]
    assert sorted(paths) == sorted(ae.state_dict())
    enc_mid = paths.index("encoder.mid_res_1.norm1.weight")
    assert enc_mid > max(i for i, p in enumerate(paths) if p.startswith("encoder.down_"))
    assert enc_mid < paths.index("encoder.norm_out.weight")
    dec_mid = paths.index("decoder.mid_res_1.norm1.weight")
    assert paths.index("decoder.conv_in.bias") < dec_mid
    assert dec_mid < min(i for i, p in enumerate(paths) if p.startswith("decoder.up_"))
    unet = DiffusionUNet3D(**MID_KW)
    assert sorted(e.path for e in P.unet_manifest(unet)) == sorted(unet.state_dict())


def test_wrong_shape_raises_with_context(tiny):
    _, params, bridged, jax_manifest, port_manifest = tiny["autoencoder"]
    sd = _reference_file(jax_manifest, params, "split", False)
    key = list(sd)[4]
    sd[key] = torch.zeros(7, 7)
    with pytest.raises(P.ImportMismatchError) as e:
        _import(bridged, port_manifest, sd)
    assert "our manifest around entry 4" in str(e.value) and key in str(e.value)


def test_leftover_tensors_rejected(tiny):
    _, params, bridged, jax_manifest, port_manifest = tiny["unet"]
    sd = _reference_file(jax_manifest, params, "fused", False)
    sd["extra.weight"] = torch.zeros(4, 4)
    with pytest.raises(P.ImportMismatchError, match="1 torch tensors left unconsumed.*extra"):
        _import(bridged, port_manifest, sd)


def test_exhausted_checkpoint_and_odd_qkv_bias_count_raise(tiny):
    _, params, bridged, jax_manifest, port_manifest = tiny["autoencoder"]
    sd = _reference_file(jax_manifest, params, "split", False)
    with pytest.raises(P.ImportMismatchError, match="exhausted"):
        _import(bridged, port_manifest, dict(list(sd.items())[:-1]))
    key = next(k for k in sd if k.endswith("to_k.bias"))
    with pytest.raises(P.ImportMismatchError, match=r"2 biases \(need 0 or 3\)"):
        _import(bridged, port_manifest, {k: v for k, v in sd.items() if k != key})


# --- the CLIs ----------------------------------------------------------------

def _write_reference_files(tiny, tmp_path, qkv_mode):
    paths = {}
    for name in ("autoencoder", "unet", "discriminator"):
        _, params, _, jax_manifest, _ = tiny[name]
        paths[name] = tmp_path / f"{name}.pt"
        torch.save(_reference_file(jax_manifest, params, qkv_mode, name == "unet"), paths[name])
    return paths


def test_import_cli_then_inference_matches_jax(tiny, tmp_path):
    """Reference files in, ``cli.inference --device cpu`` out: the NIfTI
    volume equals the JAX pipeline's on the CLI's condition and noise."""
    paths = _write_reference_files(tiny, tmp_path, "split")
    env = _env(tmp_path, tmp_path / "ckpt")
    cfg_path = port_preset_path(TINY)
    port_import(["-c", cfg_path, "-e", env, "--device", "cpu", "--autoencoder",
                 str(paths["autoencoder"]), "--diffusion", str(paths["unet"]),
                 "--scale-factor", str(SCALE_FACTOR)])
    meta = CheckpointManager(str(tmp_path / "ckpt"), "diffusion").load_meta("best")
    assert meta == {"imported_from": str(paths["unet"]), "scale_factor": SCALE_FACTOR}
    for name, role in (("autoencoder", "autoencoder"), ("unet", "diffusion")):
        got = CheckpointManager(str(tmp_path / "ckpt"), role).load("best")["state_dict"]
        assert all(torch.equal(got[k], v) for k, v in tiny[name][2].state_dict().items())

    written = port_inference(["-c", cfg_path, "-e", env, "--sampler", "ddim", "--steps", "2",
                              "--device", "cpu"])
    vol, _ = read_nifti(written[0])

    from ldm3d_tpu.data import prepare_dataloader

    args = SimpleNamespace(**json.loads(Path(env).read_text()))
    _, val = prepare_dataloader(args, 1, [32, 32, 32], randcrop=False, num_hosts=1, host_id=0)
    images = np.clip(next(iter(val.epoch(0)))["image"], 0, 1)
    gen = torch.Generator().manual_seed(5)
    eps = torch.randn((1, 8, 8, 8, 4), generator=gen).numpy()
    noise = torch.randn((1, 8, 8, 8, 4), generator=gen).numpy()
    jae, ae_params = tiny["autoencoder"][:2]
    junet, u_params = tiny["unet"][:2]
    ref = _jax_sample(jae, ae_params, junet, u_params,
                      dict(num_train_timesteps=16, beta_start=0.0015, beta_end=0.0195,
                           num_inference_steps=2), images, eps, noise, 1.0)
    np.testing.assert_allclose(vol, ref[0, ..., 0], atol=ATOL, rtol=0)


def test_import_cli_refusals_and_derived_scale_factor(tiny, tmp_path):
    paths = _write_reference_files(tiny, tmp_path, "fused")
    env = _env(tmp_path, tmp_path / "ckpt")
    cfg_path = port_preset_path(TINY)
    base = ["-c", cfg_path, "-e", env, "--device", "cpu"]
    with pytest.raises(SystemExit):  # nothing to import
        port_import(base)
    with pytest.raises(SystemExit):  # derive needs trained VAE weights
        port_import(base + ["--diffusion", str(paths["unet"]), "--derive-scale-factor"])
    # the bundled presets have no discriminator_def, which the JAX CLI builds
    with pytest.raises(ConfigResolutionError, match="config key not found: 'discriminator_def'"):
        port_import(base + ["--discriminator", str(paths["discriminator"])])
    cfg = load_json(cfg_path)
    cfg["discriminator_def"] = {"_target_": "monai.networks.nets.PatchDiscriminator",
                                "spatial_dims": 3, "num_layers_d": 3, "channels": 4,
                                "in_channels": 1, "out_channels": 1}
    with_disc = tmp_path / "with_disc.json"
    with_disc.write_text(json.dumps(cfg))
    port_import(["-c", str(with_disc), "-e", env, "--device", "cpu", "--discriminator",
                 str(paths["discriminator"]), "--autoencoder", str(paths["autoencoder"])])
    d = CheckpointManager(str(tmp_path / "ckpt"), "discriminator").load("best")
    assert d["meta"] == {"imported_from": str(paths["discriminator"])}
    assert all(torch.equal(d["state_dict"][k], v)
               for k, v in tiny["discriminator"][2].state_dict().items())
    # the VAE imported above derives the scale factor in a later run
    port_import(base + ["--diffusion", str(paths["unet"]), "--derive-scale-factor"])
    sf = CheckpointManager(str(tmp_path / "ckpt"), "diffusion").load_meta("best")["scale_factor"]
    assert np.isfinite(sf) and sf > 0 and sf != 1.0


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_export_cli_round_trips_through_the_import_cli(tiny, tmp_path, fused):
    save_two_stage(str(tmp_path / "a"), tiny["autoencoder"][2], tiny["unet"][2], 0.7)
    env_a = tmp_path / "env_a.json"
    env_a.write_text(json.dumps({"model_dir": str(tmp_path / "a")}))
    cfg_path = port_preset_path(TINY)
    qkv = ["--fused-qkv"] if fused else []
    port_export(["-c", cfg_path, "-e", str(env_a), "--device", "cpu", "--autoencoder",
                 str(tmp_path / "ae.pt"), "--diffusion", str(tmp_path / "u.pt"), *qkv])
    exported = torch.load(tmp_path / "u.pt", weights_only=True)
    mode = "fused" if fused else "split"
    _, u_params, _, jax_manifest, _ = tiny["unet"]
    _assert_same_export(J.export_torch_state_dict(jax_manifest(u_params), u_params, mode),
                        exported)
    env_b = tmp_path / "env_b.json"
    env_b.write_text(json.dumps({"model_dir": str(tmp_path / "b")}))
    port_import(["-c", cfg_path, "-e", str(env_b), "--device", "cpu", "--autoencoder",
                 str(tmp_path / "ae.pt"), "--diffusion", str(tmp_path / "u.pt")])
    for name, role in (("autoencoder", "autoencoder"), ("unet", "diffusion")):
        got = CheckpointManager(str(tmp_path / "b"), role).load("best")["state_dict"]
        assert all(torch.equal(got[k], v) for k, v in tiny[name][2].state_dict().items())
    with pytest.raises(SystemExit):  # nothing to export
        port_export(["-c", cfg_path, "-e", str(env_a), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="ema"):
        port_export(["-c", cfg_path, "-e", str(env_a), "--device", "cpu", "--diffusion",
                     str(tmp_path / "e.pt"), "--use-ema"])
