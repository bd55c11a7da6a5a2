"""The port's doc2query expansion against splade_tpu's, with the reference
test's deterministic fake generator (the T5 wrapper needs a local
checkpoint, so neither package's test reaches it): ``expand_shard`` and
the thread-pooled ``expand_documents`` rewrite each shard to the same
bytes, and the module imports without ``transformers``, which the T5
generator and ``finetune_doc2query`` import only when called."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from splade_tpu.preprocessing import doc2query as ref
from splade_tpu_torch.preprocessing import doc2query as port

ROOT = Path(__file__).resolve().parent.parent


def fake_generator(texts):
    return [[f"{t.split()[0]} 질문 {i}" for i in range(3)] for t in texts]


def blank_for_odd(texts):
    """Empty or whitespace-only generations for every other document."""
    return [["  ", ""] if len(t) % 2 else [f"{t[:2]} 요약", " 더 "]
            for t in texts]


def make_shards(root: Path, n: int = 2, rows: int = 5) -> list:
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in range(n):
        lines = [{"query": f"q{s}{i}", "positive": f"문서{s}{i} 본문 내용" + "가" * i}
                 for i in range(rows)]
        p = root / f"shard{s}.jsonl"
        p.write_text("\n".join(json.dumps(r, ensure_ascii=False)
                               for r in lines) + "\n\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("generator", [fake_generator, blank_for_odd])
@pytest.mark.parametrize("num_queries,batch_size", [(2, 16), (5, 2)])
def test_expand_shard_writes_the_references_bytes(tmp_path, generator,
                                                  num_queries, batch_size):
    got = []
    for m in (port, ref):
        path = make_shards(tmp_path / m.__name__, n=1, rows=7)[0]
        n = m.expand_shard(path, generator, num_queries=num_queries,
                           batch_size=batch_size)
        got.append((n, Path(path).read_bytes()))
    assert got[0] == got[1]
    assert got[0][0] == (7 if generator is fake_generator else 4)


def test_expand_documents_writes_the_references_bytes(tmp_path):
    got = []
    for m in (port, ref):
        paths = make_shards(tmp_path / m.__name__, n=3)
        total = m.expand_documents(paths, fake_generator, num_queries=3,
                                   max_workers=2)
        got.append((total, [Path(p).read_bytes() for p in paths]))
    assert got[0] == got[1] and got[0][0] == 15


def test_reference_assertions(tmp_path):
    paths = make_shards(tmp_path)
    assert port.expand_shard(paths[0], fake_generator, num_queries=2) == 5
    for line in open(paths[0], encoding="utf-8"):
        row = json.loads(line)
        assert row["positive"].split(" [SEP] ")[1].count("질문") == 2
        assert row["query"].startswith("q0")
    p = tmp_path / "s.jsonl"
    p.write_text(json.dumps({"query": "q", "positive": "본문"},
                            ensure_ascii=False))
    assert port.expand_shard(str(p), lambda texts: [[""] for _ in texts]) == 0
    assert json.loads(p.read_text())["positive"] == "본문"


def test_imports_without_transformers_and_fails_by_name_when_called():
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "from splade_tpu_torch.preprocessing import doc2query as d\n"
        "for call in (lambda: d.T5QueryGenerator('unused'),\n"
        "             lambda: d.finetune_doc2query('unused', [('c', 'q')],\n"
        "                                          'out')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'transformers' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
