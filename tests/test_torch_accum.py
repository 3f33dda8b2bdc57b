"""Gradient accumulation (``--grad-accum``): the port's ``ClippedAdam``
against ``optax.MultiSteps``.

Mirrors ``tests/test_grad_accum.py`` case for case on the port (k
micro-steps on b samples against one step on k*b, updates only every k-th
micro-step, the update of the mean gradient, the schedule re-indexed to
micro-steps, the EMA once per emitted update), and holds the port to the
JAX package's optimizers: three emitted updates at k = 2 across the
warm-up boundary of an ``_accum_schedule``-wrapped schedule, parameters and
both Adam moments within 1e-5 relative of ``optax.MultiSteps``, with the
``grad_norm`` each micro-step reports as JAX's steps do
(``optax.global_norm`` of the micro-step's gradients); and a resume in
the middle of an accumulation continues exactly.
"""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ldm3d_torch.training.state as port_state
from ldm3d_torch.nn import AutoencoderKL, PatchDiscriminator3D, init_weights_
from ldm3d_torch.training import (
    Stage1Config,
    TrainState,
    build_lr_schedule,
    make_diffusion_optimizer,
    make_optimizer,
    make_stage1_train_step,
)
from ldm3d_torch.training.stage1 import Stage1Draws, _accum_schedule
from ldm3d_tpu.training import TrainState as JaxTrainState
from ldm3d_tpu.training import build_lr_schedule as jax_build_lr_schedule
from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
from ldm3d_tpu.training import make_optimizer as jax_make_optimizer

REL = 1e-5
SHAPES = {"w": (3, 4), "b": (4,), "v": (5,)}

torch.set_num_threads(1)


def _params(torch_params: dict):
    return [torch.nn.Parameter(t.clone()) for t in torch_params.values()]


def test_accumulated_equals_large_batch():
    """k = 2 micro-steps on the halves of a batch against one step on the
    batch (no KL, no perceptual term: both losses are means over the
    samples, so the mean of the halves' gradients is the batch's)."""
    g = torch.Generator().manual_seed(0)
    ae = init_weights_(AutoencoderKL(in_channels=1, out_channels=1, latent_channels=2,
                                     channels=(4, 4, 8), num_res_blocks=(1, 1, 1),
                                     attention_levels=(False, False, False),
                                     norm_num_groups=2), g)
    disc = init_weights_(PatchDiscriminator3D(num_layers_d=2, channels=4), g)
    x = torch.rand(4, 16, 16, 16, 1, generator=g)
    eps = torch.randn(4, 4, 4, 4, 2, generator=g)
    init = {n: p.detach().clone() for n, p in ae.named_parameters()}
    d_init = {n: p.detach().clone() for n, p in disc.named_parameters()}
    sched = build_lr_schedule(None, 1e-3, 1, 1)
    step = make_stage1_train_step(ae, disc, None, Stage1Config(perceptual_weight=0.0,
                                                                kl_weight=0.0))

    def run(grad_accum, batches):
        ae.load_state_dict(init)
        disc.load_state_dict(d_init)
        g_state = TrainState(ae, make_optimizer(ae.parameters(), sched, grad_accum=grad_accum))
        d_state = TrainState(disc, make_optimizer(disc.parameters(), sched,
                                                  grad_accum=grad_accum))
        for sl in batches:
            step(g_state, d_state, x[sl], False, draws=Stage1Draws(eps[sl]))
        return {n: p.detach().clone() for n, p in ae.named_parameters()}

    full = run(1, [slice(0, 4)])
    acc = run(2, [slice(0, 2), slice(2, 4)])
    name = next(iter(init))
    assert not torch.allclose(acc[name], init[name])
    delta_full = float((full[name] - init[name]).abs().mean())
    delta_acc = float((acc[name] - init[name]).abs().mean())
    assert 0.2 < delta_acc / delta_full < 5.0


def test_multisteps_updates_only_every_k():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], build_lr_schedule(None, 1e-2, 1, 1), grad_accum=3)
    p0 = p.detach().clone()
    for count in range(3):
        p.grad = torch.ones(3)
        opt.step(count)
        if count < 2:
            torch.testing.assert_close(p.detach(), p0, rtol=0, atol=0)  # no update yet
    assert not torch.allclose(p.detach(), p0)  # the k-th micro-step applies


def test_multisteps_applies_the_average_gradient():
    """After k micro-gradients the update equals one plain step on their
    mean: g1 and g2 point in different directions, so a sum, the last
    gradient alone or any other mix changes the update's direction."""
    sched = build_lr_schedule(None, 1e-3, 1, 1)
    g1, g2 = torch.tensor([1.0, 0.0, -4.0]), torch.tensor([0.0, 2.0, 8.0])
    acc = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    plain = torch.nn.Parameter(acc.detach().clone())
    opt_acc = make_optimizer([acc], sched, grad_accum=2)
    for count, g in enumerate((g1, g2)):
        acc.grad = g.clone()
        opt_acc.step(count)
    plain.grad = (g1 + g2) / 2.0
    make_optimizer([plain], sched).step(0)
    torch.testing.assert_close(acc.detach(), plain.detach(), rtol=1e-6, atol=1e-7)


def test_accum_schedule_reindexes_to_micro_steps():
    sched = lambda c: 0.1 * c  # noqa: E731
    assert float(_accum_schedule(sched, 4)(10)) == float(sched(40))
    assert _accum_schedule(sched, 1) is sched
    assert _accum_schedule(0.5, 4) == 0.5


def test_ema_updates_once_per_emitted_step():
    d = 0.5
    model = torch.nn.Linear(4, 1, bias=False)
    opt = make_diffusion_optimizer(model.parameters(), lambda c: 0.1, grad_accum=2)
    st = TrainState(model, opt, ema_decay=d, ema_every=2)
    p0 = model.weight.detach().clone()
    model.weight.grad = torch.ones_like(model.weight)
    st.apply_gradients()  # micro-step 1: accumulate only
    torch.testing.assert_close(model.weight.detach(), p0, rtol=0, atol=0)
    torch.testing.assert_close(st.ema_params["weight"], p0, rtol=0, atol=0)  # not decayed
    model.weight.grad = torch.ones_like(model.weight)
    st.apply_gradients()  # micro-step 2: emit
    p1 = model.weight.detach().clone()
    assert not torch.allclose(p1, p0)
    torch.testing.assert_close(st.ema_params["weight"], d * p0 + (1 - d) * p1,
                               rtol=1e-6, atol=0)  # exactly one decay


def _grads(n: int, seed: int = 0) -> list[dict]:
    """n micro-steps' gradients of varying size: some under the clip norm,
    some over it."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = (0.05, 3.0, 0.4, 1.5, 0.02, 6.0)[i % 6]
        out.append({k: (scale * rng.standard_normal(s)).astype(np.float32)
                    for k, s in SHAPES.items()})
    return out


def _adam_moments(opt_state):
    """(mu, nu) of the Adam state inside an optax state tree."""
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append((node.mu, node.nu))
        elif isinstance(node, tuple):
            for child in node:
                visit(child)
        elif hasattr(node, "inner_opt_state"):
            visit(node.inner_opt_state)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


def _assert_rel(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= REL * scale, what


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_accumulation_matches_optax_multisteps(stage):
    """Three emitted updates at k = 2 (six micro-steps) over a warm-up
    cosine whose boundary falls between the second and third updates."""
    k, micro = 2, 6
    rng = np.random.default_rng(1)
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    jsched = jax_build_lr_schedule("warmup_cosine", 1e-2, 8, 1, warmup_epochs=3)
    psched = build_lr_schedule("warmup_cosine", 1e-2, 8, 1, warmup_epochs=3)
    params = _params({n: torch.from_numpy(v) for n, v in init.items()})
    if stage == "stage1":
        jtx = jax_make_optimizer(jsched, 0.5, grad_accum=k)
        opt = make_optimizer(params, psched, 0.5, grad_accum=k)
    else:
        jtx = jax_make_diffusion_optimizer(jsched, grad_accum=k)
        opt = make_diffusion_optimizer(params, psched, grad_accum=k)
    jstate = JaxTrainState.create(lambda *a: None, {n: jnp.asarray(v) for n, v in init.items()},
                                  jtx)
    pstate = TrainState(torch.nn.ParameterDict(dict(zip(SHAPES, params))), opt)
    for g in _grads(micro):
        jstate = jstate.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})
        jnorm = float(optax.global_norm({n: jnp.asarray(v) for n, v in g.items()}))
        for p, name in zip(params, SHAPES):
            p.grad = torch.from_numpy(g[name].copy())
        pnorm = float(pstate.apply_gradients())
        assert abs(pnorm - jnorm) <= REL * jnorm
    mu, nu = _adam_moments(jstate.opt_state)
    for p, name in zip(params, SHAPES):
        _assert_rel(p.detach().numpy(), jstate.params[name], f"param {name}")
        adam = opt.adam.state[p]
        _assert_rel(adam["exp_avg"].numpy(), mu[name], f"mu {name}")
        _assert_rel(adam["exp_avg_sq"].numpy(), nu[name], f"nu {name}")
        assert int(adam["step"]) == micro // k
    assert int(jstate.step) == pstate.step == micro


def test_resume_mid_accumulation_is_exact():
    """A state saved after 3 micro-steps at k = 2 (one update emitted, one
    micro-gradient accumulated) and loaded into a fresh optimizer continues
    bit for bit as the run that was not interrupted."""
    k = 2
    rng = np.random.default_rng(2)
    init = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in SHAPES.items()}
    sched = build_lr_schedule("warmup_cosine", 1e-2, 8, 1, warmup_epochs=3)
    grads = _grads(6, seed=3)

    def fresh():
        model = torch.nn.ParameterDict({n: torch.nn.Parameter(t.clone())
                                        for n, t in init.items()})
        return TrainState(model, make_diffusion_optimizer(model.parameters(), sched,
                                                          grad_accum=k),
                          ema_decay=0.9, ema_every=k)

    def run(state, gs):
        for g in gs:
            for name, p in state.model.items():
                p.grad = torch.from_numpy(g[name].copy())
            state.apply_gradients()

    whole = fresh()
    run(whole, grads)
    first = fresh()
    run(first, grads[:3])
    assert first.optimizer.mini_step == 1
    buf = io.BytesIO()
    torch.save(first.state_dict(), buf)
    buf.seek(0)
    resumed = fresh()
    resumed.load_state_dict(torch.load(buf, weights_only=True))
    run(resumed, grads[3:])
    for name in init:
        torch.testing.assert_close(resumed.model[name], whole.model[name], rtol=0, atol=0)
        torch.testing.assert_close(resumed.ema_params[name], whole.ema_params[name],
                                   rtol=0, atol=0)
    for p_r, p_w in zip(resumed.optimizer.params, whole.optimizer.params):
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(resumed.optimizer.adam.state[p_r][key],
                                       whole.optimizer.adam.state[p_w][key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="grad-accum"):
        model = torch.nn.ParameterDict({n: torch.nn.Parameter(t.clone())
                                        for n, t in init.items()})
        make_diffusion_optimizer(model.parameters(), sched).load_state_dict(
            first.optimizer.state_dict())


def test_clip_gets_the_accumulated_mean(monkeypatch):
    """What the k-th micro-step hands to the clip is optax's running mean
    of the micro-gradients (within float rounding of their plain mean)."""
    seen = []
    real = port_state.clip_by_global_norm_

    def recording(tensors, max_norm, norm=None):
        seen.append([t.clone() for t in tensors])
        return real(tensors, max_norm, norm)

    monkeypatch.setattr(port_state, "clip_by_global_norm_", recording)
    p = torch.nn.Parameter(torch.zeros(5))
    opt = make_diffusion_optimizer([p], lambda c: 1e-3, grad_accum=3)
    gs = [torch.randn(5, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    for count, g in enumerate(gs):
        p.grad = g.clone()
        opt.step(count)
    assert len(seen) == 1
    torch.testing.assert_close(seen[0][0], sum(gs) / 3, rtol=1e-6, atol=1e-7)
