"""The port's keyed bench-row recorder against splade_tpu's: each case of
tests/test_record.py runs through both packages' ``record_row`` on files
of their own, keeps the reference test's assertions, and the files and
results must be equal (the port's module is a copy)."""

import importlib
import json

import pytest

PACKAGES = [importlib.import_module(f"{name}.benchmark.record")
            for name in ("splade_tpu_torch", "splade_tpu")]


def row(P, recall, qps):
    return {"metric": "postings_recall@10", "n_postings": P,
            "rescore_candidates": 1000, "recall": recall, "qps": qps,
            "device": "cpu"}


def new_key_and_rewrite_same_settings(rec, out):
    rec.record_row(out, "a_p256", row(256, 0.89, 5000))
    rec.record_row(out, "a_p256", row(256, 0.90, 5200))
    data = json.loads(out.read_text())
    assert data["a_p256"]["recall"] == 0.90
    return data


def different_settings_refused(rec, out):
    rec.record_row(out, "a_select", row(256, 0.89, 5000))
    with pytest.raises(rec.KeyCollisionError, match="n_postings") as e:
        rec.record_row(out, "a_select", row(512, 0.90, 6500))
    assert json.loads(out.read_text())["a_select"]["n_postings"] == 256
    rec.record_row(out, "a_select", row(512, 0.90, 6500), force=True)
    data = json.loads(out.read_text())
    assert data["a_select"]["n_postings"] == 512
    return data, str(e.value).replace(str(out), "<out>")


def measurement_fields_not_settings(rec, out):
    s = rec.settings_of(row(256, 0.9, 1.0))
    assert "recall" not in s and "qps" not in s and "device" not in s
    assert s["n_postings"] == 256
    return s, sorted(rec.MEASUREMENT_FIELDS)


def non_dict_legacy_value_overwritable(rec, out):
    out.write_text(json.dumps({"note": "free-text"}))
    rec.record_row(out, "note", row(64, 0.5, 1.0))
    data = json.loads(out.read_text())
    assert data["note"]["n_postings"] == 64
    assert not out.with_suffix(".json.tmp").exists()
    return data


CASES = [new_key_and_rewrite_same_settings, different_settings_refused,
         measurement_fields_not_settings, non_dict_legacy_value_overwritable]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_the_reference(case, tmp_path):
    got, want = (case(rec, tmp_path / f"{i}.json")
                 for i, rec in enumerate(PACKAGES))
    assert got == want
