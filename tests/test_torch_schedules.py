"""The port's λ schedulers (splade_tpu_torch.losses.schedules) against
splade_tpu's: the same values at every step (exact: plain float
arithmetic in both) and the same state_dict round trip."""

import pytest

from splade_tpu.losses import schedules as jax_sched
from splade_tpu_torch.losses import schedules as port_sched

KINDS = [("QuadraticLambdaScheduler", {}), ("LinearLambdaScheduler", {}),
         ("ExponentialLambdaScheduler", {}),
         ("ExponentialLambdaScheduler", {"k": 2.5})]


@pytest.mark.parametrize("name,kw", KINDS,
                         ids=[n[:4] + str(k.get("k", "")) for n, k in KINDS])
@pytest.mark.parametrize("warmup", [1, 7, 20000])
def test_scheduler_values_match_jax(name, kw, warmup):
    want = getattr(jax_sched, name)(0.003, warmup, **kw)
    got = getattr(port_sched, name)(0.003, warmup, **kw)
    for step in (0, 1, warmup // 2, warmup, 3 * warmup):
        assert got.get_lambda(step) == want.get_lambda(step)
    for _ in range(5):
        assert got.step() == want.step()
    assert got.get_lambda() == want.get_lambda()
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize("name,kw", KINDS,
                         ids=[n[:4] + str(k.get("k", "")) for n, k in KINDS])
def test_scheduler_state_dict_round_trip(name, kw):
    cls = getattr(port_sched, name)
    a = cls(0.01, 10, **kw)
    for _ in range(4):
        a.step()
    b = cls(1.0, 99)
    b.load_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    assert b.step() == a.step()
    # a JAX scheduler resumes from the port's state and the other way round
    j = getattr(jax_sched, name)(1.0, 99)
    j.load_state_dict(a.state_dict())
    assert j.get_lambda() == a.get_lambda()


def test_scheduler_shapes():
    q = port_sched.QuadraticLambdaScheduler(2.0, 10)
    lin = port_sched.LinearLambdaScheduler(2.0, 10)
    e = port_sched.ExponentialLambdaScheduler(2.0, 10)
    assert q.get_lambda(5) == 0.5 and lin.get_lambda(5) == 1.0
    assert 0 < e.get_lambda(5) < q.get_lambda(5)
    for s in (q, lin, e):
        assert s.get_lambda(0) == 0.0
        assert s.get_lambda(10) == s.get_lambda(1000) == pytest.approx(2.0)
    assert port_sched.LinearLambdaScheduler(1.0, 0).warmup_steps == 1
