"""The port's corpus IDF against splade_tpu's, on the same inputs.

``compute_idf`` (bm25 and standard smoothing), ``triplet_texts`` and
``load_idf`` are copies: on seeded Hangul shards (every text field kind:
``negative``, ``negatives``, empty and missing fields, blank lines) with a
deterministic word tokenizer and a character tokenizer, the IDF arrays
and metadata are bitwise the reference's, and a ``<prefix>.bin`` /
``.json`` pair in the C++ tool's layout (little-endian f32 plus metadata)
loads bitwise in both. The C++ tool itself against an HF tokenizer is the
reference's own test (``tests/test_idf_tool.py``), which needs the
A.X-Encoder tokenizer that is not in the repository."""

import json
import math

import numpy as np
import pytest

from splade_tpu.utils import idf as ref
from splade_tpu_torch.utils import idf as port
from splade_tpu_torch.utils.synth import random_hangul_stems


class WordTok:
    """Word ids from a fixed table; unknown words get ids past the vocab
    (which compute_idf must skip), some words repeat within a text."""

    def __init__(self, words):
        self.ids = {w: i for i, w in enumerate(words)}

    def __call__(self, text, add_special_tokens=False, truncation=False):
        return {"input_ids": [self.ids.get(w, 10_000 + len(w))
                              for w in text.split()]}


class CharTok:
    def __call__(self, text, add_special_tokens=False, truncation=False):
        return {"input_ids": [ord(c) % 997 for c in text if not c.isspace()]}


def write_shards(tmp_path, seed: int = 0):
    rng = np.random.default_rng(seed)
    stems = random_hangul_stems(rng, 120)

    def text():
        return " ".join(stems[j] for j in rng.integers(0, 120, int(
            rng.integers(1, 12))))

    paths = []
    for s in range(3):
        rows = []
        for i in range(40):
            row = {"query": text(), "positive": text()}
            if i % 3 == 0:
                row["negative"] = text()
            elif i % 3 == 1:
                row["negatives"] = [text(), "", text()]
            else:
                row["negative"] = ""
            rows.append(json.dumps(row, ensure_ascii=False))
        p = tmp_path / f"train_{s}.jsonl"
        p.write_text("\n".join(rows[:20]) + "\n\n" + "\n".join(rows[20:]),
                     encoding="utf-8")
        paths.append(str(p))
    return paths, stems


@pytest.mark.parametrize("mode", ["bm25", "standard"])
@pytest.mark.parametrize("tok", ["word", "char"])
def test_compute_idf_is_bitwise(tmp_path, mode, tok):
    paths, stems = write_shards(tmp_path)
    texts = port.triplet_texts(paths)
    assert texts == ref.triplet_texts(paths)
    assert len(texts) == 3 * (40 * 2 + 14 + 13 * 2)
    tokenizer = WordTok(stems[:100]) if tok == "word" else CharTok()
    vocab = 100 if tok == "word" else 997
    got, got_meta = port.compute_idf(texts, tokenizer, vocab, mode=mode)
    want, want_meta = ref.compute_idf(texts, tokenizer, vocab, mode=mode)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got_meta == want_meta and got_meta["mode"] == mode
    assert 0 < got_meta["df_nonzero"] <= vocab


def test_idf_formulas():
    vocab = {"a": 0, "b": 1, "c": 2}

    class Tok:
        def __call__(self, text, **kw):
            return {"input_ids": [vocab[w] for w in text.split()]}

    texts = ["a b", "a", "c"]
    for m in (port, ref):
        idf, meta = m.compute_idf(texts, Tok(), 10, mode="bm25")
        assert meta["num_docs"] == 3
        assert idf[0] == pytest.approx(math.log(1 + (3 - 2 + 0.5) / 2.5))
        idf_std, _ = m.compute_idf(texts, Tok(), 10, mode="standard")
        assert idf_std[0] == pytest.approx(math.log(3 / 3))


@pytest.mark.parametrize("mode", ["bm25", "standard"])
def test_load_idf_reads_the_tools_layout(tmp_path, mode):
    paths, _ = write_shards(tmp_path, seed=1)
    idf, meta = port.compute_idf(port.triplet_texts(paths), CharTok(), 997,
                                 mode=mode)
    prefix = str(tmp_path / "idf")
    idf.astype("<f4").tofile(prefix + ".bin")
    (tmp_path / "idf.json").write_text(json.dumps(meta))
    for m in (port, ref):
        back, back_meta = m.load_idf(prefix)
        assert back.dtype == np.dtype("<f4")
        np.testing.assert_array_equal(back, idf)
        assert back_meta == meta
    meta["vocab_size"] += 1
    (tmp_path / "idf.json").write_text(json.dumps(meta))
    with pytest.raises(AssertionError):
        port.load_idf(prefix)
