"""End-to-end parity of the port's sampling path with the JAX package.

* ``inferer.sample`` (DDIM reverse loop, ``/ scale_factor``, decode) on the
  ``config_tiny_cpu`` models with shared weights, noise and condition, with
  and without classifier-free guidance.
* The inference CLI (``ldm3d_torch.cli.inference.main``, ``--device cpu``)
  on checkpoints carrying the same weights: its NIfTI output against the JAX
  pipeline fed the CLI's conditioning volume and its generator's noise.
* The CLI's conditioning volumes against the JAX validation loader's.

fp32 on the CPU. Tolerance for a whole sample: atol 1e-4 on the decoded
volume (|volume| up to about 3): three UNet calls and a decode carry fp32
summation-order differences, amplified by the DDIM step's 1/sqrt(alpha_bar);
the measured difference is about 5e-6.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_models, port_models, ref_jit

from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.data import val_condition_volumes
from ldm3d_torch.diffusion import DDIMScheduler as PortDDIM
from ldm3d_torch.diffusion import inferer as port_inferer
from ldm3d_torch.utils.nifti import read_nifti
from ldm3d_tpu.diffusion import DDIMScheduler as JaxDDIM
from ldm3d_tpu.diffusion import inferer as jax_inferer

torch.set_num_threads(1)

ATOL_SAMPLE = 1e-4
SCALE_FACTOR = 0.8


@pytest.fixture(scope="module")
def tiny():
    cfg, jae, ae_params, junet, u_params = jax_models("config_tiny_cpu.json", seed=3)
    tae, tunet = port_models(cfg, ae_params, u_params)
    return cfg, jae, ae_params, junet, u_params, tae, tunet


def _jax_sample(jae, ae_params, junet, u_params, sched_kw, images, eps, noise, guidance):
    """The JAX pipeline: posterior with the given eps, DDIM loop, decode (one
    program)."""
    def run(images, eps, noise):
        mu, sigma = jae.apply({"params": ae_params}, images, method="encode")
        return jax_inferer.sample(
            lambda z, t: junet.apply({"params": u_params}, z, t),
            lambda z: jae.apply({"params": ae_params}, z, method="decode_stage_2_outputs"),
            JaxDDIM.create(**sched_kw), noise, jax.random.PRNGKey(0),
            condition=mu + sigma * eps, scale_factor=SCALE_FACTOR, guidance_scale=guidance)

    return np.asarray(ref_jit(run)(jnp.asarray(images), jnp.asarray(eps), jnp.asarray(noise)))


@pytest.mark.parametrize("guidance", [1.0, 2.5])
def test_sample_matches_jax(tiny, guidance):
    cfg, jae, ae_params, junet, u_params, tae, tunet = tiny
    patch = cfg["diffusion_train"]["patch_size"]
    latent = (2, *[p // 4 for p in patch], cfg["latent_channels"])
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (2, *patch, 1)).astype(np.float32)
    eps = rng.standard_normal(latent, dtype=np.float32)
    noise = rng.standard_normal(latent, dtype=np.float32)
    sched_kw = dict(num_train_timesteps=16, beta_start=0.0015, beta_end=0.0195,
                    num_inference_steps=3)
    ref = _jax_sample(jae, ae_params, junet, u_params, sched_kw, images, eps, noise, guidance)

    condition = tae.encode_stage_2_inputs(torch.from_numpy(images), torch.from_numpy(eps))
    out = port_inferer.sample(tunet, tae.decode_stage_2_outputs, PortDDIM.create(**sched_kw),
                              torch.from_numpy(noise), condition=condition,
                              scale_factor=SCALE_FACTOR, guidance_scale=guidance).numpy()
    assert out.shape == images.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL_SAMPLE, rtol=0)


def _env(tmp_path, model_dir, **extra):
    env = {"model_dir": str(model_dir), "output_dir": str(tmp_path / "out"), "seed": 5,
           "synthetic_data": True, "synthetic_num": 4, "synthetic_shape": [40, 40, 40],
           **extra}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


def test_cli_matches_jax_pipeline(tiny, tmp_path):
    cfg, jae, ae_params, junet, u_params, tae, tunet = tiny
    save_two_stage(str(tmp_path / "ckpt"), tae, tunet, SCALE_FACTOR)
    env = _env(tmp_path, tmp_path / "ckpt")
    timings = {}
    written = port_inference(["-c", port_preset_path("config_tiny_cpu.json"), "-e", env,
                              "--sampler", "ddim", "--steps", "2", "--device", "cpu"],
                             timings=timings)
    assert len(written) == 1 and written[0].endswith(".nii.gz")
    vol, _ = read_nifti(written[0])
    assert vol.shape == (32, 32, 32) and np.isfinite(vol).all()
    assert all(len(timings[k]) == 1 for k in ("encode_ms", "denoise_ms", "decode_ms"))

    # the JAX pipeline on the CLI's inputs: the conditioning volume of the JAX
    # validation loader, and the CLI generator's posterior noise, then noise
    from ldm3d_tpu.data import prepare_dataloader

    args = SimpleNamespace(**json.loads(open(env).read()))
    _, val = prepare_dataloader(args, 1, [32, 32, 32], randcrop=False, num_hosts=1, host_id=0)
    images = np.clip(next(iter(val.epoch(0)))["image"], 0, 1)
    gen = torch.Generator().manual_seed(5)
    eps = torch.randn((1, 8, 8, 8, 4), generator=gen).numpy()
    noise = torch.randn((1, 8, 8, 8, 4), generator=gen).numpy()
    sched_kw = dict(num_train_timesteps=16, beta_start=0.0015, beta_end=0.0195,
                    num_inference_steps=2)
    ref = _jax_sample(jae, ae_params, junet, u_params, sched_kw, images, eps, noise, 1.0)
    np.testing.assert_allclose(vol, ref[0, ..., 0], atol=ATOL_SAMPLE, rtol=0)


def test_condition_volumes_match_jax_val_loader(tmp_path):
    from ldm3d_tpu.data import prepare_dataloader

    args = SimpleNamespace(synthetic_data=True, synthetic_num=5, synthetic_shape=[24, 20, 22],
                           seed=2, val_fraction=0.4)
    _, val = prepare_dataloader(args, 3, [16, 16, 16], randcrop=False, num_hosts=1, host_id=0)
    ref = next(iter(val.epoch(0)))["image"]
    out = val_condition_volumes(args, 3, [16, 16, 16])
    assert out.shape == ref.shape == (3, 16, 16, 16, 1)
    np.testing.assert_array_equal(out, ref)


def test_cli_needs_cuda_unless_cpu_is_asked_for(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, _, _, _, tae, tunet = tiny
    save_two_stage(str(tmp_path / "ckpt"), tae, tunet, 1.0)
    env = _env(tmp_path, tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_inference(["-c", port_preset_path("config_tiny_cpu.json"), "-e", env, "--steps", "2"])


@pytest.mark.parametrize("sampler", ["ddpm", "dpm", "dpm3"])
def test_cli_unported_samplers_name_the_roadmap(sampler, tiny, tmp_path):
    """Every sampler runs, and ``--use-distilled`` (which overrides
    ``--sampler``) too: one case each of what the flag refuses, as the JAX
    CLI does. ddpm: no distilled checkpoint, ``FileNotFoundError``; dpm: with
    ``--use-ema``, ``ValueError``; dpm3: ``--guidance 2.0``, ``ValueError``
    from the meta alone, before the weights load. (``--fused-decode`` runs:
    tests/test_torch_fused_sample.py; the distilled sample itself:
    tests/test_torch_distill.py.)"""
    _, _, _, _, _, tae, tunet = tiny
    save_two_stage(str(tmp_path / "ckpt"), tae, tunet, 1.0)
    env = _env(tmp_path, tmp_path / "ckpt")
    argv = ["-c", port_preset_path("config_tiny_cpu.json"), "-e", env, "--sampler", sampler,
            "--use-distilled", "--device", "cpu"]
    if sampler == "ddpm":
        with pytest.raises(FileNotFoundError, match="no 'distilled' checkpoint found"):
            port_inference(argv)
    elif sampler == "dpm":
        with pytest.raises(ValueError, match="mutually exclusive"):
            port_inference(argv + ["--use-ema"])
    else:
        from ldm3d_torch.ckpt import CheckpointManager

        ckpt = CheckpointManager(str(tmp_path / "ckpt"), "diffusion")
        ckpt.save("distilled", {"state_dict": {}}, {"timesteps": [8], "guidance_scale": 1.5})
        loads = []
        original = CheckpointManager.load

        def counted(self, *args, **kwargs):
            loads.append(args)
            return original(self, *args, **kwargs)

        CheckpointManager.load = counted
        try:
            with pytest.raises(ValueError, match="bakes guidance w=1.5 in"):
                port_inference(argv + ["--guidance", "2.0"])
        finally:
            CheckpointManager.load = original
        assert loads == []


def _cli_volume(env, *extra):
    written = port_inference(["-c", port_preset_path("config_tiny_cpu.json"), "-e", env,
                              "--steps", "4", "--device", "cpu", *extra])
    return np.stack([read_nifti(p)[0] for p in written])


def test_cli_default_sampler_is_ddpm(tiny, tmp_path):
    """As in the JAX CLI, --sampler defaults to ddpm: the same seed gives the
    explicit ddpm volume, not the ddim one."""
    _, _, _, _, _, tae, tunet = tiny
    save_two_stage(str(tmp_path / "ckpt"), tae, tunet, SCALE_FACTOR)
    env = _env(tmp_path, tmp_path / "ckpt")
    default = _cli_volume(env)
    np.testing.assert_array_equal(default, _cli_volume(env, "--sampler", "ddpm"))
    assert np.abs(default - _cli_volume(env, "--sampler", "ddim")).max() > 1e-3


def test_cli_use_ema_and_decode_chunk(tiny, tmp_path):
    """--use-ema samples with the 'ema' UNet role (and raises without one);
    --decode-chunk 1 decodes a batch of 2 a volume at a time, to the same
    volumes up to fp32 summation order (the CPU's convolutions pick their
    algorithm by batch size)."""
    from ldm3d_torch.ckpt import CheckpointManager

    _, _, _, _, _, tae, tunet = tiny
    model_dir = tmp_path / "ckpt"
    save_two_stage(str(model_dir), tae, tunet, SCALE_FACTOR)
    env = _env(tmp_path, model_dir)
    base = ("--sampler", "dpm", "--batch", "2")
    whole = _cli_volume(env, *base)
    np.testing.assert_allclose(_cli_volume(env, *base, "--decode-chunk", "1"), whole,
                               atol=1e-5, rtol=0)
    with pytest.raises(FileNotFoundError, match="ema"):
        _cli_volume(env, *base, "--use-ema")
    ema = {k: v * 0.9 if k.endswith("weight") else v for k, v in tunet.state_dict().items()}
    CheckpointManager(str(model_dir), "diffusion").save("ema", {"state_dict": ema})
    assert np.abs(_cli_volume(env, *base, "--use-ema") - whole).max() > 1e-3
