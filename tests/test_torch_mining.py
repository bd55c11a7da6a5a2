"""The port's teacher-score precompute and multi-negative miner against
splade_tpu's: tests/test_mining_export.py::test_precompute_then_mine_pipeline
through both packages on the same shard and teacher. The scored and mined
JSONL files and the embedding cache (``teacher_embeddings.npy``,
``text_to_idx.json``) must be byte-identical (the port's modules are
copies); the cache is reused without encoding, and only the delta is
encoded when the inputs grow."""

import json
import zlib

import numpy as np
import pytest

from splade_tpu import mining as jax_mining
from splade_tpu_torch import mining
from splade_tpu_torch.mining.teacher_scores import collect_unique_texts


class ToyTeacher:
    """Deterministic normalized embeddings from word hashes."""

    def __init__(self):
        self.encoded = 0

    def encode(self, texts):
        self.encoded += len(texts)
        out = np.zeros((len(texts), 32), np.float32)
        for i, t in enumerate(texts):
            for w in t.split():
                out[i, zlib.crc32(w.encode()) % 32] += 1.0
        n = np.linalg.norm(out, axis=1, keepdims=True)
        n[n == 0] = 1.0
        return out / n


class Boom:
    def encode(self, texts):
        raise AssertionError("should have used the cache")


@pytest.fixture
def shard(tmp_path):
    rng = np.random.default_rng(0)
    words = "서울 부산 대구 검색 모델 학습 여행 음식 역사 과학".split()
    rows = []
    for i in range(24):
        mk = lambda n: " ".join(rng.choice(words, size=n, replace=False))
        row = {"query": mk(3), "positive": mk(5), "negative": mk(5)}
        if i % 5 == 0:
            row = {"query": row["query"], "positive": row["positive"],
                   "negatives": [mk(4), mk(4)]}
        rows.append(row)
    p = tmp_path / "train.jsonl"
    p.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in rows))
    return p


def _pipeline(pkg, shard, root):
    scored = root / "scored.jsonl"
    cache = root / "cache"
    teacher = ToyTeacher()
    meta = pkg.precompute_teacher_scores(str(shard), str(scored), teacher,
                                         cache_dir=str(cache))
    assert meta["scored"] == 24 and teacher.encoded == meta["unique_texts"]
    rows = [json.loads(l) for l in scored.read_text().splitlines()]
    assert all("teacher_pos_score" in r for r in rows)
    assert all(-1.01 <= r["teacher_pos_score"] <= 1.01 for r in rows)
    meta2 = pkg.precompute_teacher_scores(str(shard), str(scored), Boom(),
                                          cache_dir=str(cache))
    assert meta2["scored"] == 24
    mined = root / "mined.jsonl"
    m = pkg.mine_multi_negatives(str(scored), str(mined), str(cache),
                                 num_negatives=3, rank_lo=1, rank_hi=10,
                                 search_k=20)
    assert m["mined"] > 0
    for r in (json.loads(l) for l in mined.read_text().splitlines()):
        if "negatives" in r and "teacher_neg_scores" in r:
            assert len(r["negatives"]) == len(r["teacher_neg_scores"])
            assert r["positive"] not in r["negatives"]
            assert "negative" not in r
    # a grown input: only the new texts are encoded, the cache extended
    grown = root / "grown.jsonl"
    grown.write_text(shard.read_text() + "\n" + json.dumps(
        {"query": "새 질의", "positive": "새 문서", "negative": "서울 부산"},
        ensure_ascii=False))
    teacher = ToyTeacher()
    meta3 = pkg.precompute_teacher_scores(str(grown), str(root / "g.jsonl"),
                                          teacher, cache_dir=str(cache))
    assert teacher.encoded == 3 and meta3["scored"] == 25
    return [meta, meta2, m, meta3] + [
        (root / rel).read_bytes() for rel in (
            "scored.jsonl", "mined.jsonl", "g.jsonl",
            "cache/teacher_embeddings.npy", "cache/text_to_idx.json")]


def test_precompute_then_mine_pipeline_matches_jax(shard, tmp_path):
    got = _pipeline(mining, shard, tmp_path / "port")
    want = _pipeline(jax_mining, shard, tmp_path / "jax")
    for g, w in zip(got[:4], want[:4]):
        assert {k: v for k, v in g.items() if k != "cache"} == {
            k: v for k, v in w.items() if k != "cache"}
    assert got[4:] == want[4:]


def test_mining_with_three_negatives_fills_every_row(tmp_path):
    """num_negatives=3 from ranks 10-50 over a pool of 60 positives: every
    row gets 3 negatives and their scores, none its own positive, as the
    reference's miner gives."""
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(40)]
    rows = [{"query": " ".join(rng.choice(words, 3)),
             "positive": " ".join(rng.choice(words, 6)),
             "negative": " ".join(rng.choice(words, 6))} for _ in range(60)]
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in rows))
    out = {}
    for name, pkg in (("port", mining), ("jax", jax_mining)):
        d = tmp_path / name
        pkg.precompute_teacher_scores(str(src), str(d / "s.jsonl"),
                                      ToyTeacher(), cache_dir=str(d / "c"))
        meta = pkg.mine_multi_negatives(str(d / "s.jsonl"), str(d / "m.jsonl"),
                                        str(d / "c"), num_negatives=3)
        out[name] = (meta, (d / "m.jsonl").read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][0]["mined"] == 60
    for r in map(json.loads, out["port"][1].decode().splitlines()):
        assert len(r["negatives"]) == len(r["teacher_neg_scores"]) == 3
        assert r["positive"] not in r["negatives"]


def test_empty_pool_and_unique_texts(tmp_path):
    rows = [{"query": "a", "positive": "b", "negative": "c",
             "negatives": ["d", "b"]}, {"query": "a", "positive": ""}]
    texts, idx = collect_unique_texts(rows)
    assert texts == ["a", "b", "c", "d"] and len(idx) == 4
    (tmp_path / "c").mkdir()
    np.save(tmp_path / "c" / "teacher_embeddings.npy", np.zeros((1, 4)))
    (tmp_path / "c" / "text_to_idx.json").write_text("{}")
    (tmp_path / "in.jsonl").write_text(json.dumps(rows[0]))
    with pytest.raises(ValueError, match="empty mining pool"):
        mining.mine_multi_negatives(str(tmp_path / "in.jsonl"),
                                    str(tmp_path / "o.jsonl"),
                                    str(tmp_path / "c"))
