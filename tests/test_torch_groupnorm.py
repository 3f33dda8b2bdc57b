"""Parity of the port's GroupNorm (``ldm3d_torch/ops/groupnorm.py`` and
``GroupNorm32`` of ``ldm3d_torch/nn/blocks.py``) with the JAX package's.

* ``gn_sums`` / ``gn_bwd_sums``: the port's plain versions (what the CUDA
  kernels of ``csrc/groupnorm_sums.cu`` compute) against the JAX package's
  Pallas kernels in interpret mode (``use_pallas=True, interpret=True``) and
  its default dot-against-ones form, on the same ``(B, V, C)`` numpy input,
  read by the port through ``(B, C, V)`` and NCDHW ``channels_last_3d`` views
  of it (the layouts the port's activations have). Tolerance: 1e-5 of the
  sum of the absolute terms of each (batch, channel), the fp32 rounding of
  sums taken in different orders.
* ``GroupNorm32``'s forward and its ``(dx, dscale, dbias)`` against
  ``jax.vjp`` of ``_gn_affine`` (``ldm3d_tpu/nn/blocks.py:255``): atol 1e-4 in
  fp32; in bf16, within 2^-6 of the largest |value| (both round the same fp32
  coefficients to bf16, and XLA may fuse the bf16 multiply-add that PyTorch
  rounds twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d_torch.nn.blocks import GroupNorm32
from ldm3d_torch.ops import groupnorm as tgn
from ldm3d_tpu.nn.blocks import _gn_affine
from ldm3d_tpu.ops.groupnorm import gn_bwd_sums as jax_gn_bwd_sums
from ldm3d_tpu.ops.groupnorm import gn_sums as jax_gn_sums

SUM_REL = 1e-5
ATOL = 1e-4


def _bvc(shape, seed):
    rng = np.random.default_rng(seed)
    b, v, c = shape
    x = (rng.standard_normal(shape) + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    mean = rng.standard_normal((b, c)).astype(np.float32)
    inv = (rng.uniform(0.5, 2.0, (b, c))).astype(np.float32)
    return x, dy, mean, inv


def _assert_sums_close(got, want, terms):
    tol = SUM_REL * np.abs(terms).sum(axis=1)
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) / tol)


@pytest.mark.parametrize("use_pallas", [True, None])
@pytest.mark.parametrize("layout", ["bcv", "channels_last_3d"])
def test_sums_match_jax(use_pallas, layout):
    b, d, h, w, c = 2, 4, 6, 8, 16
    x, dy, mean, inv = _bvc((b, d * h * w, c), seed=1)

    def port_view(a):
        t = torch.from_numpy(a)
        if layout == "bcv":
            return t.permute(0, 2, 1)                       # (B, C, V), channels minor
        return t.reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)  # NCDHW, channels_last_3d

    xt, dyt = port_view(x), port_view(dy)
    if layout == "channels_last_3d":
        assert xt.is_contiguous(memory_format=torch.channels_last_3d)
    s1, s2 = tgn.gn_sums(xt)
    b1, b2 = tgn.gn_bwd_sums(dyt, xt, torch.from_numpy(mean), torch.from_numpy(inv))
    kw = dict(use_pallas=use_pallas, interpret=True)
    r1, r2 = jax_gn_sums(jnp.asarray(x), **kw)
    q1, q2 = jax_gn_bwd_sums(jnp.asarray(dy), jnp.asarray(x), jnp.asarray(mean),
                             jnp.asarray(inv), **kw)
    xhat = (x - mean[:, None, :]) * inv[:, None, :]
    _assert_sums_close(s1.numpy(), np.asarray(r1), x)
    _assert_sums_close(s2.numpy(), np.asarray(r2), x * x)
    _assert_sums_close(b1.numpy(), np.asarray(q1), dy)
    _assert_sums_close(b2.numpy(), np.asarray(q2), dy * xhat)


def test_bwd_sums_take_dy_in_another_layout():
    """dy may arrive in another memory layout than x (autograd's choice)."""
    x, dy, mean, inv = _bvc((2, 60, 8), seed=2)
    xt = torch.from_numpy(x).reshape(2, 3, 4, 5, 8).permute(0, 4, 1, 2, 3)   # channels_last
    dyt = torch.from_numpy(dy).reshape(2, 3, 4, 5, 8).permute(0, 4, 1, 2, 3).contiguous()
    got = tgn.gn_bwd_sums(dyt, xt, torch.from_numpy(mean), torch.from_numpy(inv))
    want = jax_gn_bwd_sums(jnp.asarray(dy), jnp.asarray(x), jnp.asarray(mean), jnp.asarray(inv))
    xhat = (x - mean[:, None, :]) * inv[:, None, :]
    _assert_sums_close(got[0].numpy(), np.asarray(want[0]), dy)
    _assert_sums_close(got[1].numpy(), np.asarray(want[1]), dy * xhat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 4, 32), 8), ((1, 3, 5, 7, 64), 32)])
def test_groupnorm_forward_and_vjp_match_jax(dtype, shape, groups):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.4).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    y_ref, vjp = jax.vjp(lambda x_, s_, b_: _gn_affine(x_, s_, b_, groups, 1e-6),
                         jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias))
    dx_ref, ds_ref, db_ref = vjp(jnp.asarray(dy).astype(jdt))

    gn = GroupNorm32(c, groups, 1e-6)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = (torch.from_numpy(x).to(tdt).permute(0, 4, 1, 2, 3)
          .contiguous(memory_format=torch.channels_last_3d).requires_grad_())
    y = gn(xt)
    y.backward(torch.from_numpy(dy).to(tdt).permute(0, 4, 1, 2, 3))
    assert y.dtype == tdt and xt.grad.dtype == tdt and gn.weight.grad.dtype == torch.float32

    def ndhwc(t):
        return t.detach().float().permute(0, 2, 3, 4, 1).numpy()

    pairs = [(ndhwc(y), y_ref), (ndhwc(xt.grad), dx_ref),
             (gn.weight.grad.numpy(), ds_ref), (gn.bias.grad.numpy(), db_ref)]
    for name, (got, want) in zip(("y", "dx", "dscale", "dbias"), pairs):
        want = np.asarray(want, dtype=np.float32)
        tol = ATOL if dtype == "float32" else 2.0**-6 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


# --- the launch plan of the one-launch gn_sums kernel (csrc/groupnorm_sums.cu)

def _plan_hits(plan):
    """How often the kernel's threads read each (batch, voxel, channel) under
    ``plan``: block (group, split, b) of ``ct`` channel lanes x ``rows`` voxel
    rows, lane tx reading channels group * ct * vec + tx * vec + e (e < vec)
    where they start below C, row ty voxels split * chunk + ty, + rows, ...
    below the chunk's end and V."""
    groups, nsplit, b = plan.grid
    hits = np.zeros((b, plan.v, plan.c), np.int64)
    tx = np.arange(plan.ct)
    for g in range(groups):
        c0 = g * plan.ct * plan.vec + tx * plan.vec
        chans = (c0[c0 < plan.c][:, None] + np.arange(plan.vec)).ravel()
        for s in range(nsplit):
            v0, v1 = s * plan.chunk, min(plan.v, (s + 1) * plan.chunk)
            voxels = np.concatenate([np.arange(v0 + ty, v1, plan.rows) for ty in range(plan.rows)])
            for bi in range(b):
                np.add.at(hits, (bi, voxels[:, None], chans[None, :]), 1)
    return hits


@pytest.mark.parametrize("shape,dtype,strides,align,vec", [
    ((2, 1000, 64), torch.float32, (64000, 64, 1), 0, 4),       # channels_last_3d, 16-byte loads
    ((2, 1000, 64), torch.bfloat16, (64000, 64, 1), 0, 8),
    ((1, 125, 1024), torch.float32, (128000, 1024, 1), 0, 4),   # a batch-1 UNet level: one chunk
    ((1, 4096, 96), torch.bfloat16, (393216, 96, 1), 0, 8),     # many chunks
    ((1, 4096, 96), torch.bfloat16, (393216, 96, 1), 2, 1),     # pointer off 16 bytes
    ((3, 700, 36), torch.bfloat16, (25200, 36, 1), 0, 1),       # 8 does not divide C
    ((2, 300, 64), torch.float32, (19202, 64, 1), 0, 1),        # batch stride off 16 bytes
    ((2, 900, 3), torch.float32, (2700, 3, 1), 0, 1),           # fewer channels than lanes
])
def test_gn_sums_plan_covers_every_element_once(shape, dtype, strides, align, vec):
    """The launch plan is a pure function of (B, V, C, dtype, strides, the
    pointer's offset from 16 bytes): every voxel and channel of every batch is
    read exactly once, the grid fits its limits, a block is 256 threads, and
    16-byte loads are taken only where the pointer, the batch and voxel
    strides sit on 16 bytes and the 16 bytes divide C."""
    plan = tgn.gn_sums_plan(*shape, dtype, strides, align)
    assert plan == tgn.gn_sums_plan(*shape, dtype, strides, align)
    assert plan.vec == vec
    assert plan.ct * plan.rows == 256 and plan.ct <= 32 and plan.ct & (plan.ct - 1) == 0
    groups, nsplit, b = plan.grid
    assert b == shape[0] and 1 <= nsplit <= 65535 and groups * plan.ct * plan.vec >= shape[2]
    assert (nsplit - 1) * plan.chunk < shape[1] <= nsplit * plan.chunk  # no empty chunk
    assert plan.cluster == (1 < nsplit <= 8)  # a portable cluster holds 8 blocks
    assert np.all(_plan_hits(plan) == 1)


def test_gn_sums_plan_raises_on_channels_not_minor():
    with pytest.raises(ValueError, match="unit channel stride"):
        tgn.gn_sums_plan(2, 60, 8, torch.float32, (480, 1, 60))
