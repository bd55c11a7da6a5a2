"""The port's graded token-level ranking metrics against splade_tpu's.

Each case of tests/test_evaluation.py runs through the port's
``splade_tpu_torch.evaluation`` and the JAX package's
``splade_tpu.evaluation``, keeps the reference test's assertions on both,
and the two results must be equal (the port's module is a copy)."""

import importlib

import numpy as np
import pytest

PACKAGES = {name: importlib.import_module(f"{name}.evaluation")
            for name in ("splade_tpu_torch", "splade_tpu")}


class TokMap:
    all_special_ids = [0]

    def decode(self, ids):
        return {1: "계약", 2: "해지", 3: "사유", 4: "날씨", 5: "해지",
                0: "<pad>"}.get(ids[0], f"t{ids[0]}")


def ranked_tokens_masks_special_and_orders(ev, tmp):
    rm = ev.RankingMetrics(TokMap())
    ranked = rm.ranked_tokens(np.array([9.0, 1.0, 3.0, 2.0, 0.0]))
    assert ranked == [("해지", 3.0), ("사유", 2.0), ("계약", 1.0)]
    # two ids decoding to one string count once; the cut at top_k
    dup = rm.ranked_tokens(np.array([0, 1.0, 3.0, 2.0, 0, 2.5]), top_k=2)
    assert dup == [("해지", 3.0), ("사유", 2.0)]
    return ranked, dup, ev.RankingMetrics().ranked_tokens(np.array([0, 2.0]))


def recall_mrr_golden(ev, tmp):
    rm = ev.RankingMetrics()
    out = (rm.recall_at_k(["a", "b", "c"], ["b", "z"], 2),
           rm.mrr(["x", "y", "b"], ["b"]), rm.mrr(["x"], ["b"]),
           rm.recall_at_k(["a"], [], 1))
    assert out[:3] == (pytest.approx(0.5), pytest.approx(1 / 3), 0.0)
    return out


def graded_ndcg_golden(ev, tmp):
    grades = {"a": 3, "b": 1}
    dcg = 1 / np.log2(2) + 7 / np.log2(3)
    idcg = 7 / np.log2(2) + 1 / np.log2(3)
    out = (ev.RankingMetrics.ndcg(["b", "a"], grades, 10),
           ev.RankingMetrics.ndcg(["a", "b"], grades, 10),
           ev.RankingMetrics.ndcg(["z"], {"z": 0}, 10),
           ev.RankingMetrics.dcg(["b", "x", "a"], grades, 2))
    assert out[:3] == (pytest.approx(dcg / idcg), pytest.approx(1.0), 0.0)
    return out


def evaluate_with_domains_and_persistence(ev, tmp):
    rm = ev.RankingMetrics(TokMap())
    ds = ev.EvaluationDataset("t")
    ds.add("q1", {"계약": 3, "해지": 2}, domain="legal")
    ds.add("q2", {"날씨": 2}, domain="weather")
    ds.add("q3", {"사유": 1})
    vecs = [np.array([0, 5.0, 4.0, 0, 0]), np.array([0, 0, 0, 0, 2.0]),
            np.array([0, 0, 0, 1.0, 0])]
    out = rm.evaluate(vecs, ds, ks=(1, 5))
    assert out["legal"]["recall@5"] == pytest.approx(1.0)
    assert out["weather"]["recall@5"] == pytest.approx(1.0)
    assert "overall" in out and "_nodomain" in out
    ds.save(str(tmp / "sub" / "ds.json"))
    back = ev.EvaluationDataset.load(str(tmp / "sub" / "ds.json"))
    assert back.items[0].grades == {"계약": 3, "해지": 2}
    assert back.filter_domain("legal").items[0].query == "q1"
    assert rm.evaluate([], ev.EvaluationDataset("empty")) == {"overall": {}}
    return out, back.domains(), [it.relevant_tokens(2) for it in back.items]


def model_comparison(ev, tmp):
    rng = np.random.default_rng(0)
    a = (0.9 + rng.normal(scale=0.02, size=30)).tolist()
    b = (0.5 + rng.normal(scale=0.02, size=30)).tolist()
    t = ev.ModelComparison.paired_t_test(a, b)
    assert t["p_value"] < 1e-6 and t["mean_diff"] > 0.3
    ci = ev.ModelComparison.bootstrap_ci(a, n_boot=200)
    assert ci["lower"] <= np.mean(a) <= ci["upper"]
    return t, ci, ev.ModelComparison.bootstrap_ci([])


def builtin_set_shape(ev, tmp):
    ds = ev.builtin_korean_eval_set()
    assert len(ds.items) >= 5
    assert set(ds.domains()) >= {"legal", "medical"}
    return ds.name, [(it.query, it.grades, it.domain) for it in ds.items]


CASES = [ranked_tokens_masks_special_and_orders, recall_mrr_golden,
         graded_ndcg_golden, evaluate_with_domains_and_persistence,
         model_comparison, builtin_set_shape]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_the_reference(case, tmp_path):
    out = []
    for name, ev in PACKAGES.items():
        (tmp_path / name).mkdir()
        out.append(case(ev, tmp_path / name))
    assert out[0] == out[1]


def test_the_port_shares_its_benchmarks_t_test():
    from splade_tpu_torch.benchmark import metrics
    from splade_tpu_torch.evaluation import ranking_metrics

    assert ranking_metrics._betainc is metrics._betainc
