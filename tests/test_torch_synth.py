"""The port's synthetic corpora (``utils/synth.py``) against splade_tpu's:
for the same seeded ``np.random.Generator`` every generator returns the
same arrays and texts bit for bit and leaves the generator in the same
state (the next draw is equal), so a caller that draws after them stays in
step too."""

import numpy as np
import pytest

from splade_tpu.utils import synth as ref
from splade_tpu_torch.utils import synth as port


def same(a, b) -> None:
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


CASES = {
    "zipf_corpus_csr": [(300, 5000), (40, 512, 16)],
    "uniform_vectors": [(20, 1000, 30), (5, 64, 64)],
    "random_hangul_stems": [(200,), (50, ("검색", "모델"))],
    "korean_morph_benchmark": [(120, 24, 90), (60, 12, 40, 6, 2)],
}


@pytest.mark.parametrize("name,args", [(n, a) for n, cases in CASES.items()
                                       for a in cases])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_are_bitwise(name, args, seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    same(getattr(port, name)(r1, *args), getattr(ref, name)(r2, *args))
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


def test_defaults_match():
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    got, want = port.korean_morph_benchmark(r1), ref.korean_morph_benchmark(r2)
    same(list(got), list(want))
    corpus, queries, qrels = got
    assert len(corpus) == 1200 and len(queries) == 240
    assert all(qrels[q] for q in queries)  # the target document is relevant


def test_stems_are_unique_hangul_after_the_seed_words():
    stems = port.random_hangul_stems(np.random.default_rng(1), 500,
                                     seed_words=("검색",))
    assert stems[0] == "검색" and len(stems) == len(set(stems)) == 501
    assert all(2 <= len(s) <= 3 and all("가" <= c <= "힣" for c in s)
               for s in stems[1:])
