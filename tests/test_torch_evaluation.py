"""The port's evaluation, held against ``ldm3d_tpu.evaluation``.

* Every metric (MAE, MSE, PSNR, SSIM with its contrast-structure term,
  MS-SSIM, the separable filter, the 2x pool) against the JAX package's on
  the same numpy volumes, fp32 on the CPU, within atol 1e-5: volumes of a
  few tens of voxels a side, thin volumes whose window is clamped (no NaN),
  and MS-SSIM truncated to the levels a volume supports. The Gaussian
  window and the level count equal JAX's; ``frechet_distance`` (numpy
  float64 both) within rtol 1e-9; ``composite_score`` equal.
* ``latent_features`` and ``evaluate_pairs`` with the VAE's features against
  JAX's on the ``config_micro_cpu`` VAE with the same weights: the report
  key for key (metrics within atol 1e-5, the Fréchet distance within rtol
  1e-4: it is the distance of Gaussians fit to 3 samples of fp32 features,
  whose square roots amplify the features' last-bit differences). The
  report's JSON holds no NaN token.
* ``cli.evaluate`` on the port alone: trimming to ``-n`` and to the set's
  size, exit 3 without a batch, exit 1 under ``--gate``.
* ``cuda`` tests (skipped without a card): SSIM, MS-SSIM and the latent
  features on the card with both ``allow_tf32`` flags True equal the CPU's
  within 1e-5. JAX is imported inside the tests that use it: the card's
  machine has none.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.cli.evaluate import main as port_evaluate
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.evaluation import (
    EvalReport,
    composite_score,
    evaluate_pairs,
    latent_features,
)
from ldm3d_torch.evaluation import metrics as M
from ldm3d_torch.nn import init_weights_

torch.set_num_threads(1)

ATOL = 1e-5


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, y


def _jm():
    from ldm3d_tpu.evaluation import metrics as jm

    return jm


SHAPES = {"cube24": (2, 24, 24, 24, 1), "thin6": (2, 6, 20, 20, 2), "even8": (1, 8, 18, 16, 1),
          "flat1": (1, 1, 12, 12, 1)}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("metric", ["mae", "mse", "psnr", "ssim3d", "ms_ssim3d"])
def test_metric_matches_jax(metric, name):
    import jax.numpy as jnp

    x, y = _pair(SHAPES[name], seed=len(name))
    ref = np.asarray(getattr(_jm(), metric)(jnp.asarray(x), jnp.asarray(y)))
    out = getattr(M, metric)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert out.shape == (x.shape[0],) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("levels", [None, 1, 2, 3])
def test_ms_ssim_levels_match_jax(levels):
    """48^3 supports 3 levels; the weights are truncated and renormalised."""
    import jax.numpy as jnp

    x, y = _pair((1, 48, 48, 48, 1), seed=7, noise=0.2)
    assert M.max_msssim_levels(48) == 3
    ref = np.asarray(_jm().ms_ssim3d(jnp.asarray(x), jnp.asarray(y), levels=levels))
    out = M.ms_ssim3d(torch.from_numpy(x), torch.from_numpy(y), levels=levels).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_ssim_cs_filter_and_pool_match_jax():
    import jax.numpy as jnp

    jm = _jm()
    x, y = _pair((2, 20, 17, 22, 3), seed=3)
    for out, ref in zip(M.ssim3d(torch.from_numpy(x), torch.from_numpy(y), return_cs=True),
                        jm.ssim3d(jnp.asarray(x), jnp.asarray(y), return_cs=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    kern = jm.gaussian_kernel1d(7, 1.5)
    np.testing.assert_array_equal(M.gaussian_kernel1d(7, 1.5), kern)
    np.testing.assert_allclose(M._filter3d(torch.from_numpy(x), torch.from_numpy(kern)).numpy(),
                               np.asarray(jm._filter3d(jnp.asarray(x), jnp.asarray(kern))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(M._avg_pool2(torch.from_numpy(x)).numpy(),
                               np.asarray(jm._avg_pool2(jnp.asarray(x))), rtol=0, atol=1e-6)
    assert [M.max_msssim_levels(n) for n in range(1, 400, 7)] == \
        [jm.max_msssim_levels(n) for n in range(1, 400, 7)]


def test_identical_volumes_give_inf_psnr_and_unit_ssim():
    x, _ = _pair((2, 12, 12, 12, 1))
    t = torch.from_numpy(x)
    assert torch.isinf(M.psnr(t, t)).all()
    np.testing.assert_allclose(M.ssim3d(t, t).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(M.ms_ssim3d(t, t).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,f", [(3, 4), (8, 2), (20, 6)])
def test_frechet_distance_matches_jax(n, f):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, f))
    b = 0.5 + 1.3 * rng.standard_normal((n, f))
    ref = _jm().frechet_distance(a, b)
    np.testing.assert_allclose(M.frechet_distance(a, b), ref, rtol=1e-9)
    assert M.frechet_distance(a, a) == pytest.approx(0.0, abs=1e-6)
    with pytest.raises(ValueError, match="equal F"):
        M.frechet_distance(a, b[:, :1])


def test_composite_score_matches_jax():
    from ldm3d_tpu.evaluation import composite_score as jax_composite_score

    for ssim in (-0.2, 0.0, 0.5, 1.0, 1.3):
        for psnr in (-3.0, 0.0, 20.0, 40.0, 55.0):
            for mae in (-0.1, 0.0, 0.3, 1.0, 2.0):
                assert composite_score(ssim, psnr, mae) == jax_composite_score(ssim, psnr, mae)


# --- the VAE's features and the report -------------------------------------------------

@pytest.fixture(scope="module")
def micro():
    from test_torch_models import jax_models, port_models

    cfg, jae, ae_params, junet, u_params = jax_models("config_micro_cpu.json", seed=5)
    tae, _ = port_models(cfg, ae_params, u_params)
    return cfg, jae, ae_params, tae


def _batches(seed, n_batches=2, b=2):
    rng = np.random.default_rng(seed)
    gen = [rng.uniform(0, 1, (b, 16, 16, 16, 1)).astype(np.float32) for _ in range(n_batches)]
    ref = [np.clip(g + 0.1 * rng.standard_normal(g.shape), 0, 1).astype(np.float32)
           for g in gen]
    return gen, ref


@pytest.mark.parametrize("pool", ["mean", "meanstd"])
def test_latent_features_match_jax(micro, pool):
    import jax.numpy as jnp

    from ldm3d_tpu.evaluation import latent_features as jax_latent_features

    _, jae, ae_params, tae = micro
    vols, _ = _batches(1)
    ref = jax_latent_features(jae, ae_params, jnp.asarray(vols[0]), pool=pool)
    out = latent_features(tae, vols[0], pool=pool)
    assert out.shape == ref.shape == (2, 2 * 2 if pool == "meanstd" else 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_batches,b", [(1, 1), (1, 3), (2, 2)])
def test_evaluate_pairs_matches_jax_report(micro, n_batches, b):
    from ldm3d_tpu.evaluation import evaluate_pairs as jax_evaluate_pairs

    _, jae, ae_params, tae = micro
    gen, ref = _batches(n_batches + b, n_batches, b)
    # an identical pair gives PSNR inf, taken as the 40 dB ceiling
    ref[0][0] = gen[0][0]
    want = jax_evaluate_pairs(gen, ref, ae=jae, ae_params=ae_params)
    got = evaluate_pairs(gen, ref, ae=tae)
    assert set(vars(got)) == set(vars(want))
    assert got.num_samples == want.num_samples == n_batches * b
    for key in ("mae", "mse", "psnr", "ssim", "ms_ssim", "score"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=ATOL,
                                   err_msg=key)
    if want.frechet is None:
        assert got.frechet is None
    else:
        np.testing.assert_allclose(got.frechet, want.frechet, rtol=1e-4)
    assert set(got.per_sample) == set(want.per_sample)
    for key, values in want.per_sample.items():
        np.testing.assert_allclose(got.per_sample[key], values, rtol=0, atol=ATOL, err_msg=key)


def test_report_json_never_holds_a_nan_token(tmp_path):
    gen, ref = _batches(2, 1, 2)
    gen[0][1] = np.nan  # a broken model output: the score is NaN, the gate fails closed
    report = evaluate_pairs(gen, ref)
    assert math.isnan(report.score) and math.isnan(report.mae) and report.frechet is None
    assert not report.passed(0.0)

    def refuse(token):
        raise AssertionError(f"non-strict JSON token {token}")

    text = report.to_json()
    parsed = json.loads(text, parse_constant=refuse)
    assert parsed["score"] is None and parsed["per_sample"]["mae"][0] is not None
    path = report.save(str(tmp_path / "sub" / "report.json"))
    assert json.loads(open(path).read(), parse_constant=refuse) == parsed
    inf = EvalReport(1, 0.0, 0.0, float("inf"), 1.0, 1.0, None, 1.0, {"psnr": [float("inf")]})
    assert json.loads(inf.to_json(), parse_constant=refuse)["psnr"] is None


def test_evaluate_pairs_rejects_unequal_lists():
    gen, ref = _batches(0, 2, 1)
    with pytest.raises(ValueError, match="equal, non-empty"):
        evaluate_pairs(gen, ref[:1])
    with pytest.raises(ValueError, match="equal, non-empty"):
        evaluate_pairs([], [])


# --- the CLI on the port alone ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evaluate")
    ns = SimpleNamespace(**load_json(preset_path("config_tiny_cpu.json")))
    gen = torch.Generator().manual_seed(6)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    save_two_stage(str(tmp / "ckpt"), ae, unet, 0.8)
    env = {"model_dir": str(tmp / "ckpt"), "output_dir": str(tmp / "out"), "seed": 0,
           "synthetic_data": True, "synthetic_num": 5, "synthetic_shape": [32, 32, 32],
           "val_fraction": 0.4}
    path = tmp / "env.json"
    path.write_text(json.dumps(env))
    return str(path), tmp


def _evaluate(env, *extra, timings=None):
    return port_evaluate(["-c", preset_path("config_tiny_cpu.json"), "-e", env, "--device",
                          "cpu", "--steps", "2", *extra], timings=timings)


@pytest.mark.parametrize("num,batch,expected", [(1, 1, 1), (5, 1, 2), (5, 3, 2), (2, 2, 2)])
def test_cli_trims_to_num_and_to_the_set(tiny_env, num, batch, expected):
    """The val set holds 2 pairs; the loader pads a partial batch, which is
    trimmed so no pair counts twice."""
    env, tmp = tiny_env
    timings: dict = {}
    report = _evaluate(env, "-n", str(num), "--batch", str(batch), timings=timings)
    assert report.num_samples == expected
    assert (report.frechet is None) == (expected < 2)
    saved = json.loads((tmp / "ckpt" / "evaluation_report.json").read_text())
    assert saved["num_samples"] == expected and len(timings["sample_ms"]) >= 1


def test_cli_exit_codes(tiny_env, tmp_path):
    env, _ = tiny_env
    with pytest.raises(SystemExit) as no_batch:
        _evaluate(env, "-n", "0")
    assert no_batch.value.code == 3
    with pytest.raises(SystemExit) as gate:
        _evaluate(env, "-n", "1", "--gate", "--threshold", "1.0", "--report",
                  str(tmp_path / "r.json"))
    assert gate.value.code == 1 and (tmp_path / "r.json").exists()
    report = _evaluate(env, "-n", "1", "--gate", "--threshold", "-1.0", "--report",
                       str(tmp_path / "r2.json"))
    assert report.passed(-1.0)


# --- on the card ----------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's SSIM and features against the CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["ssim3d", "ms_ssim3d"])
def test_metric_on_card_with_tf32_flags_on_equals_cpu(metric):
    _card()
    from ldm3d_torch.cli.common import tf32_flags

    x, y = _pair((2, 40, 40, 40, 1), seed=9)
    cpu = getattr(M, metric)(torch.from_numpy(x), torch.from_numpy(y))
    with tf32_flags(True):
        card = getattr(M, metric)(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
        assert torch.backends.cudnn.allow_tf32  # the metric leaves the caller's flags
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_latent_features_on_card_with_tf32_flags_on_equal_cpu():
    _card()
    from ldm3d_torch.cli.common import tf32_flags

    ns = SimpleNamespace(**load_json(preset_path("config_tiny_cpu.json")))
    ae = init_weights_(define_instance(ns, "autoencoder_def"),
                       torch.Generator().manual_seed(3)).eval()
    vols, _ = _pair((2, 32, 32, 32, 1), seed=4)
    cpu = latent_features(ae, vols)
    with tf32_flags(True):
        card = latent_features(ae.cuda(), vols)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=ATOL)
