"""YAML/env/CLI config loading with typed overrides (a copy of
``splade_tpu/config/loader.py``; PyYAML is imported only to read or write a
YAML file, so the port runs where it is not installed).

Semantics mirror the reference loader (reference: src/train/config/loader.py:22-160):

- ``load_config(path, overrides=...)``: YAML dict deep-merged over dataclass
  defaults, then ``TRAIN_SECTION__KEY`` environment variables (double
  underscore separates section from key; values are parsed as YAML scalars so
  ``TRAIN_TRAINING__LEARNING_RATE=1e-4`` becomes a float), then explicit
  override dicts (used by the CLI flags).
- ``save_config``: round-trip the resolved config to YAML/JSON.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

from splade_tpu_torch.config.v33 import V33Config

ENV_PREFIX = "TRAIN_"


def _deep_merge(base: Dict[str, Any], update: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``update`` into ``base`` (update wins)."""
    out = dict(base)
    for key, val in update.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, Mapping):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def _parse_scalar(raw: str) -> Any:
    """Parse an env-var string as a typed scalar (int/float/bool/str).

    Handles forms YAML 1.1 misses, e.g. '2e-5' (no dot) as a float.
    """
    s = raw.strip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:  # the scalars YAML would give, without it
        return {"true": True, "false": False, "null": None,
                "~": None}.get(s.lower(), raw)
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return raw


def apply_env_overrides(
    cfg_dict: Dict[str, Any], environ: Optional[Mapping[str, str]] = None
) -> Dict[str, Any]:
    """Apply ``TRAIN_SECTION__KEY`` env overrides onto a nested config dict.

    Reference behavior: src/train/config/loader.py:115-143 (double-underscore
    nesting, typed parsing, silently ignores unknown sections).
    """
    environ = os.environ if environ is None else environ
    import copy

    out = copy.deepcopy(cfg_dict)  # overrides must not mutate the caller
    for name, raw in environ.items():
        if not name.startswith(ENV_PREFIX) or "__" not in name:
            continue
        path = name[len(ENV_PREFIX):].lower().split("__")
        node = out
        ok = True
        for part in path[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                ok = False
                break
            node = nxt
        if ok:
            node[path[-1]] = _parse_scalar(raw)
    return out


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> V33Config:
    """Resolve a V33Config: defaults < YAML < env < explicit overrides. A
    ``.json`` path (``save_config``'s resolved config) is read without
    PyYAML."""
    cfg_dict = V33Config().to_dict()
    if path:
        with open(path) as f:
            if Path(path).suffix == ".json":
                file_dict = json.load(f)
            else:
                import yaml

                file_dict = yaml.safe_load(f) or {}
        cfg_dict = _deep_merge(cfg_dict, file_dict)
    cfg_dict = apply_env_overrides(cfg_dict, environ)
    if overrides:
        cfg_dict = _deep_merge(cfg_dict, overrides)
    return V33Config.from_dict(cfg_dict)


def save_config(cfg: V33Config, path: str) -> None:
    """Write the resolved config to .yaml or .json by extension."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    d = cfg.to_dict()
    if p.suffix in (".yml", ".yaml"):
        import yaml

        p.write_text(yaml.safe_dump(d, sort_keys=False))
    else:
        p.write_text(json.dumps(d, indent=2))
