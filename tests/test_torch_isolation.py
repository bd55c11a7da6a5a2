"""The port stands alone: no file under splade_tpu_torch/, nor chip_smoke.py,
imports jax, flax, optax, splade_tpu or safetensors (the port reads and
writes that format itself); the package imports without
transformers, safetensors, msgpack and PyYAML (msgpack is imported only
inside the checkpoint reader's functions); and entry points with no device
raise when there is no CUDA device instead of carrying on on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "splade_tpu", "safetensors")
PORT_FILES = sorted((ROOT / "splade_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax_or_the_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


NEW_MODULES = ["ops/fused_splade_v2.py", "losses/schedules.py",
               "train/preemption.py", "train/mlm.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_the_third_slices_modules_are_among_the_checked_files(rel):
    assert ROOT / "splade_tpu_torch" / rel in PORT_FILES
    assert (ROOT / "splade_tpu" / rel).exists()  # each has its counterpart


def test_the_parallel_module_is_among_the_checked_files():
    """Data parallel has its counterpart of splade_tpu/parallel/mesh.py,
    checked like every module of the port (the tests' worker processes and
    chip_smoke.py's ranks import it without jax)."""
    for rel in ("parallel/__init__.py", "parallel/mesh.py"):
        assert ROOT / "splade_tpu_torch" / rel in PORT_FILES
        assert (ROOT / "splade_tpu" / rel).exists()


def test_the_splash_attention_module_is_among_the_checked_files():
    """The splash attention has a module of its own in the port (JAX keeps
    its call inside models/modernbert.py) and its kernels' sources ship."""
    assert ROOT / "splade_tpu_torch" / "ops" / "splash_attention.py" in PORT_FILES
    assert "_splash_attention" in (
        ROOT / "splade_tpu" / "models" / "modernbert.py").read_text()
    csrc = ROOT / "splade_tpu_torch" / "csrc"
    for name in ("splash_attention.cuh", "splash_attention_fwd.cu",
                 "splash_attention_bwd.cu"):
        assert (csrc / name).exists(), name


LIBRARY_ATTENTION = ("scaled_dot_product_attention", "torch.compile",
                     "flash_attn", "xformers", "cudnn")


@pytest.mark.parametrize("path", PORT_FILES[:-1],
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES[:-1]])
def test_port_calls_no_library_attention(path):
    """The package's attention is its own: plain math or the hand-written
    kernels. Only chip_smoke.py may time a library call as a yardstick."""
    text = path.read_text()
    assert not [w for w in LIBRARY_ATTENTION if w in text], path.name


def _function_level_only(path: Path, module: str) -> bool:
    """True if ``module`` is imported in ``path`` and only inside function
    bodies."""
    tree = ast.parse(path.read_text(), filename=str(path))
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(fn))
    found = False
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.module else [])
        if any(n.split(".")[0] == module for n in names):
            if id(node) not in inside:
                return False
            found = True
    return found


def test_msgpack_is_imported_only_inside_the_checkpoint_reader():
    users = [p for p in PORT_FILES if "msgpack" in {
        m.split(".")[0] for m in _imported_modules(p)}]
    assert users == [ROOT / "splade_tpu_torch" / "train" / "checkpoint.py"]
    assert _function_level_only(users[0], "msgpack")
    # and without the package the reader says so by name
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "from splade_tpu_torch.train.checkpoint import read_msgpack_params\n"
        "try:\n"
        "    read_msgpack_params('unused')\n"
        "except ImportError as e:\n"
        "    assert 'msgpack' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_imports_without_transformers_or_safetensors():
    code = (
        "import sys\n"
        "for m in ('transformers', 'safetensors', 'jax', 'flax', 'optax',\n"
        "          'msgpack', 'yaml'):\n"
        "    sys.modules[m] = None  # any import of them now fails\n"
        "import importlib, pkgutil, splade_tpu_torch\n"
        "for m in pkgutil.walk_packages(splade_tpu_torch.__path__,\n"
        "                               'splade_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'splade_tpu' or k.startswith('splade_tpu.')\n"
        "               for k in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_without_a_device_raise_when_no_card(monkeypatch):
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.ops.impact_index import ImpactIndex
    from splade_tpu_torch.ops.cluster_index import ClusterIndex
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.ops.tiered_postings import TieredPostingsIndex
    from splade_tpu_torch.serving.engine import build_engine_from_docs
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.serving.server import main
    from splade_tpu_torch.train.cli import main as train_main
    from splade_tpu_torch.train.mlm import MLMConfig, MLMTrainer
    from splade_tpu_torch.train.mlm import main as mlm_main
    from splade_tpu_torch.train.trainer import Trainer
    from splade_tpu_torch.utils.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModernBertConfig.tiny(num_hidden_layers=1)
    for make in (lambda: resolve_device(None),
                 lambda: PostingsIndex(100),
                 lambda: TieredPostingsIndex(100),
                 lambda: ClusterIndex(100),
                 lambda: ImpactIndex(100),
                 lambda: SpladeEncoder(cfg),
                 lambda: build_engine_from_docs(None, None, []),
                 lambda: Trainer(V33Config(), None, [], None),
                 lambda: train_main(["--config", "unused.yaml"]),
                 lambda: MLMTrainer(MLMConfig(), None, [], None),
                 lambda: mlm_main(["--config", "unused.yaml"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", "unused", "--docs", "unused"])
    # asked for explicitly, the CPU is fine
    assert resolve_device("cpu").type == "cpu"
    assert PostingsIndex(100, device="cpu").device.type == "cpu"


#: the benchmark harness, evaluation and teacher tier: each module of the
#: port beside its counterpart in splade_tpu
BENCHMARK_TIER = [
    "benchmark/metrics.py", "benchmark/fusion.py", "benchmark/bm25.py",
    "benchmark/index.py", "benchmark/config.py", "benchmark/data.py",
    "benchmark/record.py", "benchmark/report.py", "benchmark/searchers.py",
    "evaluation/__init__.py", "evaluation/ranking_metrics.py",
    "models/xlmr.py", "models/teachers.py", "benchmark/encoders.py",
    "mining/__init__.py", "mining/teacher_scores.py",
    "mining/multi_negatives.py", "benchmark/runner.py",
    "benchmark/__init__.py"]
#: module -> the optional libraries it may import, inside functions only
LAZY_IMPORTS = {
    "models/teachers.py": ("transformers",),
    # reads *.safetensors with the port's own reader: no optional library
    "models/hf_port.py": (),
    "benchmark/data.py": ("datasets",),
    "benchmark/bm25.py": ("kiwipiepy", "MeCab"),
}


@pytest.mark.parametrize("rel", BENCHMARK_TIER)
def test_the_benchmark_tiers_modules_are_among_the_checked_files(rel):
    assert ROOT / "splade_tpu_torch" / rel in PORT_FILES
    assert (ROOT / "splade_tpu" / rel).exists()


OPTIONAL_LIBRARIES = ("transformers", "safetensors", "datasets",
                      "kiwipiepy", "MeCab")


@pytest.mark.parametrize("rel", sorted(LAZY_IMPORTS))
def test_optional_libraries_are_imported_inside_functions(rel):
    path = ROOT / "splade_tpu_torch" / rel
    for module in LAZY_IMPORTS[rel]:
        assert _function_level_only(path, module)
    others = {m.split(".")[0] for m in _imported_modules(path)} & (
        set(OPTIONAL_LIBRARIES) - set(LAZY_IMPORTS[rel]))
    assert not others, f"{rel} imports {others}"


#: the twelfth slice's modules: export, profiling, the tiered and cluster
#: indexes (each beside its counterpart in splade_tpu), and the port's
#: safetensors reader and writer and export CLI (which have none)
SERVING_SLICE = ["export/__init__.py", "export/hf_export.py",
                 "utils/profiling.py", "ops/tiered_postings.py",
                 "ops/cluster_index.py"]


@pytest.mark.parametrize("rel", SERVING_SLICE + ["utils/safetensors_io.py",
                                                 "export/__main__.py"])
def test_the_export_and_index_modules_are_among_the_checked_files(rel):
    assert ROOT / "splade_tpu_torch" / rel in PORT_FILES
    if rel in SERVING_SLICE:
        assert (ROOT / "splade_tpu" / rel).exists()


def test_package_imports_without_the_benchmarks_optional_libraries():
    """Neither the card machine nor a minimal install has datasets,
    kiwipiepy or MeCab (nor transformers and safetensors): every module,
    the benchmark tier's included, imports without them."""
    code = (
        "import sys\n"
        "for m in ('transformers', 'safetensors', 'datasets', 'kiwipiepy',\n"
        "          'MeCab', 'jax', 'flax', 'optax', 'msgpack', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, splade_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    splade_tpu_torch.__path__, 'splade_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'splade_tpu_torch.benchmark.runner' in names\n"
        "assert 'splade_tpu_torch.models.teachers' in names\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_benchmark_entry_points_without_a_device_raise_when_no_card(
        monkeypatch, tmp_path):
    from splade_tpu_torch.benchmark.data import BenchmarkData
    from splade_tpu_torch.benchmark.encoders import TeacherDenseEncoder
    from splade_tpu_torch.benchmark.runner import BenchmarkRunner
    from splade_tpu_torch.benchmark.runner import main as bench_main
    from splade_tpu_torch.models.teachers import BGEM3Teacher
    from splade_tpu_torch.models.xlmr import XlmRobertaConfig, XlmRobertaEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "config.json").write_text("{}")
    data = BenchmarkData("empty", {}, {}, {})
    model = XlmRobertaEncoder(XlmRobertaConfig.tiny())
    for make in (lambda: BenchmarkRunner(data),
                 lambda: bench_main(["--dataset", "triplet-val"]),
                 lambda: BGEM3Teacher(model, None),
                 lambda: TeacherDenseEncoder.from_hf_dir(str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


#: the thirteenth slice's modules: the device mesh, the doc-sharded
#: indexes and the engine's mesh routes, each beside its counterpart
MESH_SLICE = ["parallel/mesh.py", "ops/postings_index.py",
              "ops/tiered_postings.py", "ops/cluster_index.py",
              "ops/impact_index.py", "serving/engine.py"]


@pytest.mark.parametrize("rel", MESH_SLICE)
def test_the_mesh_slices_modules_are_among_the_checked_files(rel):
    assert ROOT / "splade_tpu_torch" / rel in PORT_FILES
    assert (ROOT / "splade_tpu" / rel).exists()


def test_the_mesh_and_its_indexes_raise_when_no_card(monkeypatch):
    """``make_mesh()`` with no card and no devices raises rather than
    laying the shards on the CPU; so do the mesh indexes on CUDA devices."""
    from splade_tpu_torch.ops.cluster_index import MeshShardedClusterIndex
    from splade_tpu_torch.ops.impact_index import ImpactIndex
    from splade_tpu_torch.ops.postings_index import MeshShardedPostingsIndex
    from splade_tpu_torch.ops.tiered_postings import (
        MeshShardedTieredPostingsIndex)
    from splade_tpu_torch.parallel import DeviceMesh, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cards = DeviceMesh((torch.device("cuda:0"), torch.device("cuda:1")))
    for make in (lambda: make_mesh(),
                 lambda: make_mesh(num_data=1),
                 lambda: MeshShardedPostingsIndex(100, cards),
                 lambda: MeshShardedTieredPostingsIndex(100, cards),
                 lambda: MeshShardedClusterIndex(100, cards),
                 lambda: ImpactIndex(100, mesh=cards)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # asked for explicitly, the CPU is fine
    assert make_mesh(devices=["cpu"] * 2).size == 2
