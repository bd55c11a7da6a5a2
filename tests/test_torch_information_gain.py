"""The port's information-gain filter against splade_tpu's, on the same
seeded numpy inputs.

Each case of tests/test_information_gain.py (the unit-ball volume, the
Kozachenko-Leonenko entropy against the Gaussian's analytic value and its
spread, the degenerate small n, the filter dropping trivial pairs, an
explicit threshold) runs through both packages with the reference test's
own assertions. The port computes in float64 with torch (on the CPU here,
through ``device="cpu"``), the reference in numpy: entropies and gains
agree within 1e-9 relative (of the largest gain for the gains), and the
keep/drop decisions are equal. At the module's stated width (d = 768) the
reference's log V_d overflows; the port's is finite and its filter drops
the planted trivial half of phase 11's design."""

import math

import numpy as np
import pytest
import torch

from splade_tpu import information_gain as ref
from splade_tpu_torch import information_gain as port

RTOL = 1e-9


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("d", [1, 2, 3, 8, 64, 341])
def test_unit_ball_volume_and_its_log(d):
    assert port.unit_ball_volume(d) == ref.unit_ball_volume(d)
    assert port.log_unit_ball_volume(d) == pytest.approx(
        math.log(ref.unit_ball_volume(d)), rel=1e-12, abs=1e-12)


def test_unit_ball_volume_golden():
    for m in (port, ref):
        assert m.unit_ball_volume(1) == pytest.approx(2.0)
        assert m.unit_ball_volume(2) == pytest.approx(math.pi)
        assert m.unit_ball_volume(3) == pytest.approx(4.0 / 3.0 * math.pi)


def test_the_references_log_volume_overflows_at_the_stated_width():
    """The one departure: at d = 768 the reference's math.gamma overflows
    (kl_entropy raises); the port's lgamma form is finite."""
    x = np.random.default_rng(0).normal(size=(20, 768))
    with pytest.raises(OverflowError):
        ref.kl_entropy(x, k=3)
    assert math.isfinite(port.kl_entropy(x, k=3, device="cpu"))
    assert port.log_unit_ball_volume(768) == pytest.approx(
        384 * math.log(math.pi) - math.lgamma(385), rel=1e-15)


ENTROPY_CASES = [(2000, 2, 1.5, 3, 0), (500, 3, 0.1, 3, 1), (500, 3, 2.0, 3, 1),
                 (300, 16, 1.0, 5, 2), (64, 100, 1.0, 1, 3), (4, 4, 1.0, 3, 4)]


@pytest.mark.parametrize("n,d,sigma,k,seed", ENTROPY_CASES)
def test_kl_entropy_matches(n, d, sigma, k, seed):
    x = np.random.default_rng(seed).normal(scale=sigma, size=(n, d))
    want = ref.kl_entropy(x, k=k)
    for arg in (x, torch.from_numpy(x), x.astype(np.float32)):
        got = port.kl_entropy(arg, k=k, device="cpu")
        if arg.dtype == np.float32:
            want32 = ref.kl_entropy(x.astype(np.float32), k=k)
            assert_close(got, want32)
        else:
            assert_close(got, want)
    assert isinstance(got, float)


def test_kl_entropy_reference_assertions():
    rng = np.random.default_rng(0)
    d, sigma = 2, 1.5
    x = rng.normal(scale=sigma, size=(2000, d))
    want = d / 2 * math.log(2 * math.pi * math.e * sigma ** 2)
    assert port.kl_entropy(x, k=3, device="cpu") == pytest.approx(want,
                                                                  rel=0.05)
    rng = np.random.default_rng(1)
    tight = rng.normal(scale=0.1, size=(500, 3))
    wide = rng.normal(scale=2.0, size=(500, 3))
    assert (port.kl_entropy(wide, device="cpu")
            > port.kl_entropy(tight, device="cpu"))
    assert port.kl_entropy(np.zeros((2, 4)), k=3, device="cpu") == 0.0
    assert ref.kl_entropy(np.zeros((2, 4)), k=3) == 0.0


def planted(n: int, d: int, seed: int):
    """The reference test's planted pairs: trivial targets copy their
    sources up to N(0, 0.01^2), the other half are independent."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, d))
    half = n // 2
    tgt = np.concatenate([src[:half] + rng.normal(scale=0.01,
                                                  size=(half, d)),
                          rng.normal(size=(n - half, d))])
    return src, tgt


@pytest.mark.parametrize("k,percentile,threshold", [
    (3, 50.0, None), (3, 25.0, None), (5, 10.0, None), (1, 50.0, None),
    (3, 50.0, 0.0)])
def test_filter_matches(k, percentile, threshold):
    src, tgt = planted(120, 8, 2)
    pairs = [(f"s{i}", f"t{i}") for i in range(120)]
    want = ref.InformationGainFilter(k, threshold, percentile).filter_pairs(
        pairs, src, tgt)
    filt = port.InformationGainFilter(k, threshold, percentile, device="cpu")
    got = filt.filter_pairs(pairs, torch.from_numpy(src), tgt)
    assert [(r.source, r.target) for r in got] == pairs
    g_got = [r.information_gain for r in got]
    g_want = [r.information_gain for r in want]
    assert_close(g_got, g_want)
    thr = threshold if threshold is not None else float(
        np.percentile(g_want, percentile))
    near = np.abs(np.asarray(g_want) - thr) <= RTOL * max(map(abs, g_want))
    assert [r.keep for r, x in zip(got, near) if not x] == [
        r.keep for r, x in zip(want, near) if not x]
    s_got, s_want = filt.stats(got), ref.InformationGainFilter.stats(want)
    assert (s_got["total"], s_got["kept"]) == (s_want["total"],
                                               s_want["kept"])
    assert s_got["mean_ig"] == pytest.approx(s_want["mean_ig"], rel=RTOL)


def test_filter_reference_assertions():
    src, tgt = planted(120, 8, 2)
    half = 60
    filt = port.InformationGainFilter(k=3, percentile=50.0, device="cpu")
    results = filt.filter_pairs([(f"s{i}", f"t{i}") for i in range(120)],
                                src, tgt)
    gains = np.asarray([r.information_gain for r in results])
    assert gains[half:].mean() > gains[:half].mean() + 1.0
    assert (sum(r.keep for r in results[half:])
            > sum(r.keep for r in results[:half]))
    stats = filt.stats(results)
    assert stats["total"] == 120 and 0 < stats["kept"] < 120
    rng = np.random.default_rng(3)
    everything = port.InformationGainFilter(
        k=3, threshold=-1e9, device="cpu").filter_pairs(
        [("a", "b")] * 40, rng.normal(size=(40, 4)), rng.normal(size=(40, 4)))
    assert all(r.keep for r in everything)


def test_filter_edge_cases_match():
    x = np.random.default_rng(4).normal(size=(5, 3))
    for m, kw in ((port, {"device": "cpu"}), (ref, {})):
        filt = m.InformationGainFilter(**kw)
        with pytest.raises(ValueError, match="length mismatch"):
            filt.filter_pairs([("a", "b")], x, x)
        assert filt.filter_pairs([], x[:0], x[:0]) == []
        one = filt.filter_pairs([("a", "b")], x[:1], x[1:2])
        assert [(r.information_gain, r.keep) for r in one] == [(0.0, True)]
        assert filt.stats([]) == {"total": 0, "kept": 0, "kept_rate": 0.0,
                                  "mean_ig": 0.0}
    gains = port.InformationGainFilter(device="cpu").information_gains(x, x)
    assert gains.dtype == np.float64 and gains.shape == (5,)


def grouped_pairs(n: int, seed: int, d: int = 768, rank: int = 8,
                  group: int = 4, spread: float = 0.1):
    """Phase 11 (e)'s design (``chip_smoke.ig_pairs``): embeddings in
    groups of ``group`` around N(0, 3^2) centres of a ``rank``-dim subspace
    of R^d (synonym groups); the first half's targets copy their sources up
    to N(0, 0.01^2) in all d dims, the second half's are drawn the same way
    as sources, independently, and shuffled."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, rank)))[0].T

    def draw(m):
        centres = rng.normal(scale=3.0, size=(m // group, rank))
        return (np.repeat(centres, group, axis=0)
                + rng.normal(scale=spread, size=(m, rank))) @ basis

    src = draw(n)
    half = n // 2
    tgt = src + rng.normal(scale=0.01, size=(n, d))
    tgt[half:] = draw(n - half)[rng.permutation(n - half)]
    return src, tgt


def test_filter_drops_the_planted_trivial_half_at_the_stated_width():
    src, tgt = grouped_pairs(400, 0)
    filt = port.InformationGainFilter(k=3, percentile=50.0, device="cpu")
    res = filt.filter_pairs([(str(i), str(i)) for i in range(400)], src, tgt)
    assert [r.keep for r in res] == [False] * 200 + [True] * 200


def test_filter_and_entropy_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 2))
    for make in (lambda: port.InformationGainFilter(),
                 lambda: port.kl_entropy(x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
