"""The port stands alone: no file under splade_tpu_torch/, nor chip_smoke.py,
imports jax, flax, optax or splade_tpu; the package imports without
transformers and safetensors; and entry points with no device raise when
there is no CUDA device instead of carrying on on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "splade_tpu")
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


def test_package_imports_without_transformers_or_safetensors():
    code = (
        "import sys\n"
        "for m in ('transformers', 'safetensors', 'jax', 'flax', 'optax'):\n"
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
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.serving.engine import build_engine_from_docs
    from splade_tpu_torch.serving.server import main
    from splade_tpu_torch.utils.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModernBertConfig.tiny(num_hidden_layers=1)
    for make in (lambda: resolve_device(None),
                 lambda: PostingsIndex(100),
                 lambda: ImpactIndex(100),
                 lambda: SpladeEncoder(cfg),
                 lambda: build_engine_from_docs(None, None, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", "unused", "--docs", "unused"])
    # asked for explicitly, the CPU is fine
    assert resolve_device("cpu").type == "cpu"
    assert PostingsIndex(100, device="cpu").device.type == "cpu"
