"""The port's V33 losses (splade_tpu_torch.losses.v33) against splade_tpu's
on the same numpy inputs: every function, num_blocks 1 and 2, one and three
hard negatives, KD with masked columns, the ValueError cases, and the
gradients. f32 on both sides: 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.config.v33 import V33LossConfig as JaxLossConfig
from splade_tpu.losses import v33 as jl
from splade_tpu_torch.config.v33 import V33LossConfig
from splade_tpu_torch.losses import v33 as tl

TOL = dict(rtol=1e-6, atol=1e-7)


def _reprs(seed, B=8, k=1, V=48):
    rng = np.random.default_rng(seed)
    mk = lambda *s: np.log1p(np.maximum(rng.normal(size=s), 0)).astype(
        np.float32)
    neg = mk(B, k, V) if k > 1 else mk(B, V)
    return mk(B, V), mk(B, V), neg, rng


def _both(fn_name, *arrays, **kw):
    j = getattr(jl, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    t = getattr(tl, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return float(t), float(j)


@pytest.mark.parametrize("blocks", [1, 2])
def test_flops_loss(blocks):
    a, p, n, _ = _reprs(0)
    got, want = _both("flops_loss", a, num_blocks=blocks)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("step", [0, 5, 999, 20000, 50000])
def test_lambda_schedule(step):
    got = tl.lambda_schedule(step, 3e-3, 20000, 0.1)
    want = jl.lambda_schedule(jnp.int32(step), 3e-3, 20000, 0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("temperature", [1.0, 0.05])
def test_infonce_loss(blocks, k, temperature):
    a, p, n, _ = _reprs(k, k=k)
    got, want = _both("infonce_loss", a, p, n, temperature=temperature,
                      num_blocks=blocks)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_margin_mse_loss(k):
    a, p, n, rng = _reprs(7, k=k)
    tp = rng.normal(size=8).astype(np.float32)
    tn = rng.normal(size=(8, k)).astype(np.float32)
    if k == 1:
        tn = tn[:, 0]  # the [B] form
    got, want = _both("margin_mse_loss", a, p, n, tp, tn)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("kd_t", [1.0, 2.0])
def test_kl_kd_loss_with_masked_columns(blocks, kd_t):
    a, p, _, rng = _reprs(9)
    teacher = rng.normal(size=(8, 8)).astype(np.float32)
    got, want = _both("kl_kd_loss", a, p, teacher, kd_temperature=kd_t,
                      num_blocks=blocks)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, **TOL)
    # the masked columns' gradient is 0, not NaN
    at = torch.from_numpy(a).requires_grad_()
    tl.kl_kd_loss(at, torch.from_numpy(p), torch.from_numpy(teacher),
                  kd_t, num_blocks=blocks).backward()
    assert torch.isfinite(at.grad).all()


@pytest.mark.parametrize("fn,args", [
    ("infonce_loss", 3), ("kl_kd_loss", 3)])
def test_non_dividing_blocks_raise(fn, args):
    a, p, n, rng = _reprs(2, B=6)
    extra = (n,) if fn == "infonce_loss" else (
        rng.normal(size=(6, 6)).astype(np.float32),)
    for mod, conv in ((jl, jnp.asarray), (tl, torch.from_numpy)):
        with pytest.raises(ValueError, match="not divisible"):
            getattr(mod, fn)(conv(a), conv(p), *map(conv, extra),
                             num_blocks=4)


CASES = [
    dict(),
    dict(global_in_batch_negatives=True),
    dict(lambda_neg=5e-3, lambda_kd=0.5, kd_temperature=2.0),
    dict(lambda_margin_mse=0.3, temperature=0.5),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("k,blocks", [(1, 1), (3, 2)])
def test_v33_loss_and_gradients(case, k, blocks):
    a, p, n, rng = _reprs(case + 10 * k, k=k)
    n = n if k > 1 else n[:, None, :]
    teacher = rng.normal(size=(8, 8)).astype(np.float32)
    tp = rng.normal(size=8).astype(np.float32)
    tn = rng.normal(size=(8, k)).astype(np.float32)
    kw = dict(flops_warmup_steps=100, **CASES[case])
    step = 37

    def jax_loss(a_, p_, n_):
        return jl.v33_loss(a_, p_, n_, jnp.int32(step), JaxLossConfig(**kw),
                           teacher_scores=jnp.asarray(teacher),
                           teacher_pos_scores=jnp.asarray(tp),
                           teacher_neg_scores=jnp.asarray(tn),
                           num_blocks=blocks)

    (jloss, jmet), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, p, n)]
    tloss, tmet = tl.v33_loss(*leaves, step, V33LossConfig(**kw),
                              teacher_scores=torch.from_numpy(teacher),
                              teacher_pos_scores=torch.from_numpy(tp),
                              teacher_neg_scores=torch.from_numpy(tn),
                              num_blocks=blocks)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert tmet._fields == jmet._fields
    for name in tmet._fields:
        np.testing.assert_allclose(float(getattr(tmet, name)),
                                   float(getattr(jmet, name)), **TOL,
                                   err_msg=name)
    for t, j in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_v33_loss_without_teachers_zeroes_kd():
    a, p, n, _ = _reprs(3)
    _, met = tl.v33_loss(torch.from_numpy(a), torch.from_numpy(p),
                         torch.from_numpy(n), 0,
                         V33LossConfig(lambda_kd=1.0, lambda_margin_mse=1.0))
    assert float(met.kd) == 0.0 and float(met.margin_mse) == 0.0
    assert set(met.as_dict()) == set(tl.LossMetrics._fields)
