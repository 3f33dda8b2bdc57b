"""Depth sharding (``--spatial``) of the port on 2 gloo ranks, against the
port's one process and the JAX package's spatial sampler.

One :class:`ldm3d_torch.parallel.launch.RankPool` of 2 CPU ranks serves the
file (a module fixture; every call bounded, the ranks killed on expiry),
laid out as one data replica of 2 depth slabs (``MeshSpec(spatial=2)``).
Inputs are made from seeds with numpy; the models are the micro preset's
(its patch raised to 32^3, which 2 * 2^4 divides), their weights filled
from numpy over the Flax trees' shapes (``jax.eval_shape``, no init
compile) and carried into the port by its weight bridge. In fp32, with the
rank functions of ``tests/torch_dp_ranks.py``:

* ``halo_exchange`` against the global zero padding, forward and gradient;
* ``Conv3D`` ("same", "down", 1x1), ``Upsample3D``, ``GroupNorm32`` and
  ``AttentionBlock3D`` on the slabs against one process: the output and
  the input's gradient to 1e-5, and the parameters' gradients summed over
  the ranks to 1e-5 of their largest |g| where that is above 1 (each is a
  sum over the whole volume, whose fp32 rounding grows with its size);
* attention with gathered keys and values: the output and the q, k, v
  gradients to 1e-5;
* the VAE encode and the UNet forward to 1e-4, against one process and
  against the JAX package's unsharded models (``ref_jit``);
* the spatial stage-2 train step against the one-process step on the same
  draws: loss and ``grad_norm`` within atol 2e-5 and rtol 2e-5, the applied
  gradients within 2e-5 of their largest |g|, the parameters within
  2 lr + 1e-6 (the bars of ``tests/test_torch_ddp.py``); plain, and with
  Min-SNR weights and condition dropout; the same at ``-g 4 --spatial 2``
  (two data replicas of two slabs, a pool of 4 ranks of its own); the eval
  step's loss. The one-process step is held in turn against the JAX
  package's unsharded stage-2 loss on the same draws (its encode, noising,
  UNet and ``_stage2_mse`` under ``jax.value_and_grad``, as
  ``tests/test_torch_train_full_step.py`` assembles them): loss and
  ``grad_norm`` within 1e-5 relative, the clipped gradients within 1e-4 of
  each leaf's largest |g| (the bars of ``tests/test_torch_train.py``);
* DDIM and DDPM samples to 1e-4, and the DDIM sampler against
  ``ldm3d_tpu.parallel.make_spatial_sampler`` on a ``MeshSpec(data=1,
  spatial=2)`` mesh of the CPU platform, to 1e-4.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dp_ranks as ranks
from test_torch_models import ref_jit

from ldm3d_torch.ckpt import autoencoder_state_dict_from_jax, state_dict_from_jax
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.parallel.launch import RankPool

torch.set_num_threads(1)

LR = 1e-4
TOL = dict(atol=2e-5, rtol=2e-5)
PATCH = 32
SCALE = 0.9  # the rank functions' scale factor
JAX_REL = 1e-5  # loss and grad_norm against JAX (tests/test_torch_train.py)
JAX_GRAD_REL = 1e-4  # each leaf against its largest |g| (tests/test_torch_train.py)


@pytest.fixture(scope="module", autouse=True)
def _no_tensorflow():
    with ranks.without_tensorflow():
        yield


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


def _fill(shapes, seed: int) -> dict:
    from test_torch_stage1 import _fill as fill

    return fill(shapes, seed)


@pytest.fixture(scope="module")
def micro():
    """The micro preset at a 32^3 patch: the config, the Flax models and
    their numpy-filled params, and the port's state_dicts as numpy."""
    from ldm3d_tpu.configs import ConfigResolver

    cfg = load_json(preset_path("config_micro_cpu.json"))
    cfg["diffusion_train"]["patch_size"] = [PATCH] * 3
    r = ConfigResolver(cfg)
    jae, junet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    key = jax.random.PRNGKey(0)
    ae_params = _fill(jax.eval_shape(jae.init, {"params": key, "sample": key},
                                     jnp.zeros((1, PATCH, PATCH, PATCH, 1)))["params"], 11)
    lat = PATCH // 4
    u_params = _fill(jax.eval_shape(junet.init, key,
                                    jnp.zeros((1, lat, lat, lat, junet.in_channels)),
                                    jnp.zeros((1,), jnp.int32))["params"], 12)
    ns = SimpleNamespace(**cfg)
    ae_sd = {k: v.numpy() for k, v in autoencoder_state_dict_from_jax(
        ae_params, define_instance(ns, "autoencoder_def")).items()}
    u_sd = {k: v.numpy() for k, v in state_dict_from_jax(
        u_params, define_instance(ns, "diffusion_def")).items()}
    return cfg, jae, ae_params, junet, u_params, ae_sd, u_sd


def _cat(results: list, key: str, dim: int) -> np.ndarray:
    return np.concatenate([r[key] for r in results], axis=dim)


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


@pytest.mark.parametrize("lo,hi,channels", [(1, 1, 3), (0, 1, 3), (1, 1, 1)])
def test_halo_exchange_matches_the_global_zero_padding(pool, lo, hi, channels):
    """Also: a channels_last_3d slab (one channel too) comes out with the
    exact channels_last_3d strides, which the GroupNorm kernel after the
    next convolution needs on the card."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, channels, 4, 3, 3)).astype(np.float32)
    per = x.shape[2] // 2
    w = rng.standard_normal((2, 2, channels, per + lo + hi, 3, 3)).astype(np.float32)
    out = pool.run(ranks.spatial_halo, x, w, lo, hi)
    assert all(r["cl_strides"] for r in out)
    padded = np.pad(x, ((0, 0), (0, 0), (lo, hi), (0, 0), (0, 0)))
    grad = np.zeros_like(padded)
    for i, r in enumerate(out):
        np.testing.assert_array_equal(r["out"], padded[:, :, i * per:i * per + per + lo + hi])
        grad[:, :, i * per:i * per + per + lo + hi] += w[i]
    np.testing.assert_allclose(_cat(out, "dx", 2), grad[:, :, lo:lo + x.shape[2]], atol=1e-6)


# kind -> (block class, constructor kwargs, input shape NCDHW)
BLOCKS = {
    "conv_same": ("Conv3D", dict(in_channels=4, features=5), (2, 4, 4, 5, 5)),
    "conv_down": ("Conv3D", dict(in_channels=4, features=5, stride=2, padding="down"),
                  (2, 4, 8, 5, 6)),
    "conv_1x1": ("Conv3D", dict(in_channels=4, features=5, kernel=1, padding="valid"),
                 (2, 4, 4, 3, 3)),
    "upsample": ("Upsample3D", dict(in_channels=4, out_channels=5), (2, 4, 4, 3, 3)),
    "groupnorm": ("GroupNorm32", dict(channels=8, num_groups=4), (2, 8, 4, 3, 5)),
    "attention_block": ("AttentionBlock3D", dict(channels=8, num_head_channels=4,
                                                 num_groups=4), (2, 8, 4, 3, 2)),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_sharded_block_matches_one_process(pool, kind):
    from ldm3d_torch.nn import blocks

    cls, kwargs, shape = BLOCKS[kind]
    torch.manual_seed(3)
    block = getattr(blocks, cls)(**kwargs)
    with torch.no_grad():  # non-trivial affine and biases
        for p in block.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    sd = {k: v.detach().numpy() for k, v in block.state_dict().items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d).requires_grad_(True)
    y = block(xt)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    (y * torch.from_numpy(dy)).sum().backward()
    out = pool.run(ranks.spatial_block, cls, kwargs, sd, x, dy)
    np.testing.assert_allclose(_cat(out, "y", 2), y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(_cat(out, "dx", 2), xt.grad.numpy(), atol=1e-5)
    for name, p in block.named_parameters():  # sums over the volume: 1e-5 of the largest
        ref = p.grad.numpy()
        np.testing.assert_allclose(out[0]["grads"][name] + out[1]["grads"][name], ref,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_gathered_kv_attention_matches_one_process(pool):
    from ldm3d_torch.ops.attention import volumetric_attention

    rng = np.random.default_rng(6)
    q, k, v, do = (rng.standard_normal((2, 32, 2, 8)).astype(np.float32) for _ in range(4))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    ref = volumetric_attention(qt, kt, vt)
    (ref * torch.from_numpy(do)).sum().backward()
    out = pool.run(ranks.spatial_attention, q, k, v, do)
    np.testing.assert_allclose(_cat(out, "out", 1), ref.detach().numpy(), atol=1e-5)
    for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
        np.testing.assert_allclose(_cat(out, name, 1), t.grad.numpy(), atol=1e-5, err_msg=name)


def _models(cfg, ae_sd, u_sd):
    ae = ranks._model(cfg, "autoencoder_def", ae_sd).eval()
    return ae, ranks._model(cfg, "diffusion_def", u_sd)


def test_encode_and_unet_forward_match_one_process(pool, micro):
    cfg, *_, ae_sd, u_sd = micro
    ae, unet = _models(cfg, ae_sd, u_sd)
    rng = np.random.default_rng(7)
    lat = PATCH // 4
    x = rng.uniform(0, 1, (2, PATCH, PATCH, PATCH, 1)).astype(np.float32)
    eps = rng.standard_normal((2, lat, lat, lat, cfg["latent_channels"])).astype(np.float32)
    z = rng.standard_normal((2, lat, lat, lat, unet.in_channels)).astype(np.float32)
    t = np.array([3, 11], dtype=np.int64)
    out = pool.run(ranks.spatial_models, cfg, ae_sd, u_sd, x, eps, z, t)
    with torch.no_grad():
        enc = ae.encode_stage_2_inputs(torch.from_numpy(x), torch.from_numpy(eps)).numpy()
        pred = unet(torch.from_numpy(z), torch.from_numpy(t)).numpy()
    _, jae, ae_params, junet, u_params, *_ = micro
    mu, sigma = ref_jit(lambda p, v: jae.apply({"params": p}, v, method="encode"))(
        ae_params, jnp.asarray(x))
    jenc = np.asarray(mu + sigma * jnp.asarray(eps))
    jpred = np.asarray(ref_jit(junet.apply)({"params": u_params}, jnp.asarray(z),
                                            jnp.asarray(t, jnp.int32)))
    assert np.abs(pred).max() > 1e-2
    for got in (_cat(out, "encode", 1), enc):
        np.testing.assert_allclose(got, jenc, atol=1e-4)
    for got in (_cat(out, "unet", 1), pred):
        np.testing.assert_allclose(got, jpred, atol=1e-4)


def _jax_stage2_fn(micro, train: bool, cfg_kwargs: dict):
    """The JAX package's unsharded stage-2 loss of the UNet params on a batch
    and a step's draws (its encode, noising, UNet and ``_stage2_mse``, as
    ``tests/test_torch_train_full_step.py`` assembles them), jitted; with
    ``train``, its value and gradient."""
    from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
    from ldm3d_tpu.diffusion import inferer as jax_inferer
    from ldm3d_tpu.training import Stage2Config as JaxStage2Config
    from ldm3d_tpu.training.stage2 import _stage2_mse as jax_stage2_mse

    cfg, jae, ae_params, junet = micro[:4]
    jcfg = JaxStage2Config(**cfg_kwargs)
    sched = JaxDDPM.create(num_train_timesteps=cfg["NoiseScheduler"]["num_train_timesteps"])

    def loss_fn(params, images, labels, eps_label, eps_image, noise, timesteps, keep):
        images, labels = jnp.clip(images, 0.0, 1.0), jnp.clip(labels, 0.0, 1.0)
        mu, sigma = jae.apply({"params": ae_params}, labels, method="encode")
        z = jax.lax.stop_gradient(mu + sigma * eps_label) * jnp.float32(SCALE)
        mu_i, sigma_i = jae.apply({"params": ae_params}, images, method="encode")
        cond = mu_i + sigma_i * eps_image
        if keep is not None:
            cond = cond * keep.reshape((-1, 1, 1, 1, 1)).astype(cond.dtype)
        model_in = jax_inferer.noise_prediction_inputs(sched, z, noise, timesteps, cond)
        pred = junet.apply({"params": params}, model_in, timesteps)
        target = jax_inferer.training_targets(sched, z, noise, timesteps)
        if not train:
            return jnp.mean((pred - target) ** 2)
        return jax_stage2_mse(pred, target, timesteps, sched, jcfg)

    return ref_jit(jax.value_and_grad(loss_fn) if train else loss_fn)


@pytest.fixture(scope="module")
def jax_stage2(micro):
    """``run(batch, draws, cfg_kwargs, train)``: the JAX loss (and, with
    ``train``, the global norm and the clipped gradients) on ``batch`` and
    the one-process step's ``draws``; one jit for each (train, config)."""
    fns: dict = {}

    def run(batch: dict, draws: list, cfg_kwargs: dict, train: bool):
        key = (train, tuple(sorted(cfg_kwargs.items())))
        if key not in fns:
            fns[key] = _jax_stage2_fn(micro, train, cfg_kwargs)
        eps_label, eps_image, noise, timesteps, keep = (None if a is None else jnp.asarray(a)
                                                        for a in draws)
        out = fns[key](micro[4], jnp.asarray(batch["image"]), jnp.asarray(batch["label"]),
                       eps_label, eps_image, noise, timesteps.astype(jnp.int32), keep)
        if not train:
            return float(out)
        loss, grads = out
        clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
        return float(loss), float(optax.global_norm(grads)), clipped

    return run


def _assert_one_process_matches_jax(micro, jax_stage2, one: dict, batch: dict,
                                    cfg_kwargs: dict):
    cfg, *_, u_sd = micro
    loss, norm, clipped = jax_stage2(batch, one["draws"], cfg_kwargs, train=True)
    np.testing.assert_allclose(one["metrics"]["diffusion_loss"], loss, rtol=JAX_REL)
    np.testing.assert_allclose(one["metrics"]["grad_norm"], norm, rtol=JAX_REL)
    ref = state_dict_from_jax(jax.device_get(clipped),
                              ranks._model(cfg, "diffusion_def", u_sd))
    worst = {name: float(np.abs(g - ref[name].numpy()).max()
                         / max(float(np.abs(ref[name].numpy()).max()), 1e-30))
             for name, g in one["grads"].items()}
    assert max(worst.values()) <= JAX_GRAD_REL, worst


def _batch(seed: int, rows: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-0.1, 1.1, (rows, PATCH, PATCH, PATCH, 1)).astype(np.float32)
            for k in ("image", "label")}


@pytest.mark.parametrize("cfg_kwargs", [{}, {"min_snr_gamma": 5.0, "cond_dropout": 0.5}],
                         ids=["plain", "min_snr_dropout"])
def test_spatial_train_step_matches_one_process(pool, micro, jax_stage2, cfg_kwargs):
    cfg, *_, ae_sd, u_sd = micro
    args = (cfg, ae_sd, u_sd, _batch(8), LR, 5, cfg_kwargs)
    two = pool.run(ranks.spatial_stage2_step, *args)
    one = ranks.spatial_stage2_step(*args, spatial=1)
    _assert_one_process_matches_jax(micro, jax_stage2, one, args[3], cfg_kwargs)
    assert _max_diff(two[0]["params"], two[1]["params"]) == 0.0  # the ranks agree bit for bit
    for name in ("diffusion_loss", "grad_norm"):
        np.testing.assert_allclose(two[0]["metrics"][name], one["metrics"][name], err_msg=name,
                                   **TOL)
    scale = max(float(np.max(np.abs(g))) for g in one["grads"].values())
    assert _max_diff(two[0]["grads"], one["grads"]) <= 2e-5 * scale
    assert _max_diff(two[0]["params"], one["params"]) <= 2 * LR + 1e-6


def test_data_by_spatial_train_step_on_four_ranks_matches_one_process(micro, jax_stage2):
    """``-g 4 --spatial 2``: two data replicas of two slabs each, on a pool
    of its own; each rank keeps one row and one slab of the global batch."""
    cfg, *_, ae_sd, u_sd = micro
    args = (cfg, ae_sd, u_sd, _batch(14), LR, 15, {})
    with RankPool(4, threads=1, timeout_s=300) as pool4:
        four = pool4.run(ranks.spatial_stage2_step, *args)
    one = ranks.spatial_stage2_step(*args, spatial=1)
    _assert_one_process_matches_jax(micro, jax_stage2, one, args[3], {})
    for r in four[1:]:
        assert _max_diff(four[0]["params"], r["params"]) == 0.0
    for name in ("diffusion_loss", "grad_norm"):
        np.testing.assert_allclose(four[0]["metrics"][name], one["metrics"][name], err_msg=name,
                                   **TOL)
    scale = max(float(np.max(np.abs(g))) for g in one["grads"].values())
    assert _max_diff(four[0]["grads"], one["grads"]) <= 2e-5 * scale
    assert _max_diff(four[0]["params"], one["params"]) <= 2 * LR + 1e-6


def test_spatial_eval_step_matches_one_process(pool, micro, jax_stage2):
    cfg, *_, ae_sd, u_sd = micro
    args = (cfg, ae_sd, u_sd, _batch(9), 6)
    two = pool.run(ranks.spatial_stage2_eval, *args)
    one = ranks.spatial_stage2_eval(*args, spatial=1)
    assert two[0]["loss"] == two[1]["loss"]
    np.testing.assert_allclose(two[0]["loss"], one["loss"], **TOL)
    np.testing.assert_allclose(one["loss"], jax_stage2(args[3], one["draws"], {}, train=False),
                               rtol=JAX_REL)


def _sample_inputs(cfg, seed: int):
    rng = np.random.default_rng(seed)
    lat = PATCH // 4
    noise = rng.standard_normal((1, lat, lat, lat, cfg["latent_channels"])).astype(np.float32)
    cond = rng.standard_normal((1, lat, lat, lat, cfg["latent_channels"])).astype(np.float32)
    return noise, cond


@pytest.mark.parametrize("sampler,steps", [("ddim", 3), ("ddpm", None)])
def test_spatial_sample_matches_one_process(pool, micro, sampler, steps):
    cfg, *_, ae_sd, u_sd = micro
    noise, cond = _sample_inputs(cfg, 10)
    args = (cfg, ae_sd, u_sd, sampler, steps, noise, cond, 3, 0.7)
    two = pool.run(ranks.spatial_sample, *args)
    one = ranks.spatial_sample(*args, spatial=1)
    np.testing.assert_array_equal(two[0], two[1])
    assert np.isfinite(one).all() and np.abs(one).max() > 0
    np.testing.assert_allclose(two[0], one, atol=1e-4)


def test_spatial_ddim_sampler_matches_the_jax_spatial_sampler(pool, micro):
    """The port's spatial DDIM sampler on 2 ranks against
    ``ldm3d_tpu.parallel.make_spatial_sampler`` on a (data 1, spatial 2)
    mesh of the CPU platform: DDIM is deterministic given the noise and the
    condition."""
    from ldm3d_tpu.diffusion import DDIMScheduler
    from ldm3d_tpu.parallel import MeshSpec, create_mesh, make_spatial_sampler

    cfg, jae, ae_params, junet, u_params, ae_sd, u_sd = micro
    noise, cond = _sample_inputs(cfg, 13)
    steps, scale = 2, 0.7
    sch = cfg["NoiseScheduler"]
    ddim = DDIMScheduler.create(num_inference_steps=steps,
                                num_train_timesteps=sch["num_train_timesteps"],
                                beta_start=sch["beta_start"], beta_end=sch["beta_end"])
    mesh = create_mesh(MeshSpec(data=1, spatial=2), devices=jax.devices()[:2])
    sampler = make_spatial_sampler(junet, jae, ddim, mesh, scale_factor=scale)
    ref = np.asarray(ref_jit(lambda u, a, n, c: sampler(u, a, n, jax.random.PRNGKey(0), c))(
        u_params, ae_params, jnp.asarray(noise), jnp.asarray(cond)))
    two = pool.run(ranks.spatial_sample, cfg, ae_sd, u_sd, "ddim", steps, noise, cond, 0, scale)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(two[0], ref, atol=1e-4)
