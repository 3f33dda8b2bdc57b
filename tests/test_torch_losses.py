"""Parity of the port's losses (``ldm3d_torch/losses.py``) with the JAX
package's (``ldm3d_tpu/losses/losses.py``).

The same seeded numpy inputs, in fp32 and rounded to bf16, go through both;
every loss accumulates in fp32, so the two agree to fp32 summation order:
rtol 1e-6. The KL's sigma floor and its optional [0, 1000] clamp are driven
past their edges, and the summed variants equal the means times the counts.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ldm3d_torch.losses as T
import ldm3d_tpu.losses as J

torch.set_num_threads(1)

RTOL = 1e-6


def _inputs(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.2, 1.2, (2, 6, 5, 4, 1)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
    mu = rng.standard_normal((2, 3, 3, 2, 4)).astype(np.float32)
    # sigma from 0 (below the 1e-8 floor) up, some exactly 0
    sigma = np.abs(rng.standard_normal(mu.shape)).astype(np.float32) * 2.0
    sigma.reshape(-1)[::7] = 0.0
    logits = rng.standard_normal((2, 3, 3, 2, 1)).astype(np.float32)
    arrays = [a, b, mu, sigma, logits]
    if dtype == "bfloat16":
        arrays = [x.astype(ml_dtypes.bfloat16) for x in arrays]
    return arrays


def _both(x):
    if x.dtype == ml_dtypes.bfloat16:
        return jnp.asarray(x), torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(out: torch.Tensor, ref) -> None:
    assert out.dtype == torch.float32 and out.dim() == 0
    np.testing.assert_allclose(out.item(), float(ref), rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "l1_loss_sum", "l2_loss_sum"])
def test_recon_losses_match_jax(name, dtype):
    a, b, *_ = _inputs(dtype)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    _close(getattr(T, name)(ta, tb), getattr(J, name)(ja, jb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clamp", [False, True])
def test_kl_matches_jax_with_the_floor_and_clamp(dtype, clamp):
    _, _, mu, sigma, _ = _inputs(dtype)
    (jm, tm), (js, ts) = _both(mu), _both(sigma)
    _close(T.kl_loss(tm, ts, clamp=clamp), J.kl_loss(jm, js, clamp=clamp))
    _close(T.kl_loss_sum(tm, ts), J.kl_loss_sum(jm, js))
    # the clamp holds the loss in [0, 1000]: a wide posterior goes past 1000
    big = np.full(mu.shape, 30.0, np.float32)
    (jm, tm), (js, ts) = _both(big.astype(mu.dtype)), _both(sigma)
    _close(T.kl_loss(tm, ts, clamp=clamp), J.kl_loss(jm, js, clamp=clamp))
    assert (T.kl_loss(tm, ts, clamp=clamp).item() == 1000.0) == clamp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsgan_losses_match_jax(dtype):
    *_, logits = _inputs(dtype)
    fake, real = _both(logits), _both(-logits * 0.5 + 0.25)
    _close(T.lsgan_generator_loss(fake[1]), J.lsgan_generator_loss(fake[0]))
    _close(T.lsgan_discriminator_loss(fake[1], real[1]),
           J.lsgan_discriminator_loss(fake[0], real[0]))


def test_sum_variants_are_the_means_times_the_counts():
    a, b, mu, sigma, _ = (torch.from_numpy(x) for x in _inputs("float32"))
    n = a.numel()
    torch.testing.assert_close(T.l1_loss_sum(a, b), T.l1_loss(a, b) * n, rtol=RTOL, atol=0)
    torch.testing.assert_close(T.l2_loss_sum(a, b), T.l2_loss(a, b) * n, rtol=RTOL, atol=0)
    # the KL is a mean over the batch of per-sample sums
    torch.testing.assert_close(T.kl_loss_sum(mu, sigma), T.kl_loss(mu, sigma) * mu.shape[0],
                               rtol=RTOL, atol=0)
