"""Dataset registry + loading (air-gapped aware)
(a copy of ``splade_tpu/preprocessing/downloaders.py``).

Reference: src/preprocessing/downloaders/ — 7 modules pulling 9 HF datasets
(KorNLI, KLUE-NLI, KorQuAD, KLUE-MRC, KorSTS, NSMC, YNAT, Korean
instructions, persona chat). Here: one registry describing each source
(HF name/config/split, task type, field mapping) and one loader that reads
from the local HF cache (offline mode) or from local JSONL drops under
``$SPLADE_RAW_DATA/<key>.jsonl`` — this container has zero egress, so no
network path exists.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from splade_tpu_torch.preprocessing.types import RawSample

logger = logging.getLogger(__name__)


@dataclass
class DatasetSpec:
    key: str
    task: str                       # converter key
    hf_name: str = ""
    hf_config: Optional[str] = None
    split: str = "train"
    field_map: Dict[str, str] = field(default_factory=dict)
    """raw field -> RawSample field (e.g. {"sentence1": "premise"})."""


REGISTRY: Dict[str, DatasetSpec] = {s.key: s for s in [
    DatasetSpec("kornli", "nli", "kor_nli", "multi_nli",
                # the HF dataset exposes premise/hypothesis/label; the
                # sentence1/sentence2/gold_label names appear only in the
                # raw TSVs — map BOTH so either artifact layout loads
                field_map={"sentence1": "premise", "sentence2": "hypothesis",
                           "premise": "premise", "hypothesis": "hypothesis",
                           "gold_label": "label", "label": "label"}),
    DatasetSpec("klue-nli", "nli", "klue", "nli",
                field_map={"premise": "premise", "hypothesis": "hypothesis",
                           "label": "label"}),
    DatasetSpec("korquad", "qa", "squad_kor_v1", None,
                field_map={"question": "question", "context": "context"}),
    DatasetSpec("klue-mrc", "qa", "klue", "mrc",
                field_map={"question": "question", "context": "context"}),
    DatasetSpec("korsts", "sts", "kor_nlu", "sts",
                field_map={"sentence1": "sentence1", "sentence2": "sentence2",
                           "score": "score"}),
    DatasetSpec("nsmc", "classification", "nsmc", None,
                field_map={"document": "text", "label": "label"}),
    DatasetSpec("ynat", "classification", "klue", "ynat",
                field_map={"title": "text", "label": "label"}),
    DatasetSpec("koinstruct", "dialog", "beomi/KoAlpaca-v1.1a", None,
                field_map={"instruction": "instruction", "output": "output"}),
    DatasetSpec("personachat", "dialog", "persona_chat_korean", None,
                field_map={"utterance": "utterance", "response": "response"}),
    # --- remaining reference sources (collect_korean_datasets.py's 13)
    DatasetSpec("korquad2", "qa", "squad_kor_v2", None,
                field_map={"question": "question", "context": "context"}),
    DatasetSpec("openorca-ko", "dialog", "kyujinpy/OpenOrca-KO", None,
                field_map={"question": "instruction", "response": "output"}),
    DatasetSpec("ko-alpaca", "dialog", "Bingsu/ko_alpaca_data", None,
                field_map={"instruction": "instruction", "output": "output"}),
    DatasetSpec("ko-wikidata-qa", "dialog", "maywell/ko_wikidata_QA", None,
                field_map={"instruction": "instruction", "output": "output"}),
    DatasetSpec("ko-triplet-v1", "triplet", "nlpai-lab/ko-triplet-v1.0", None,
                field_map={"query": "query", "document": "document",
                           "hard_negative": "hard_negative"}),
    DatasetSpec("opus-100-en-ko", "translation", "Helsinki-NLP/opus-100",
                "en-ko", field_map={"translation": "translation"}),
    DatasetSpec("mc4-ko", "web_passage", "mc4", "ko",
                field_map={"text": "text"}),
    DatasetSpec("wikipedia-ko", "web_passage", "wikimedia/wikipedia",
                "20231101.ko", field_map={"text": "text"}),
]}

_NLI_LABELS = {0: "entailment", 1: "neutral", 2: "contradiction"}


def _map_fields(row: Dict[str, Any], spec: DatasetSpec) -> Dict[str, Any]:
    out = {}
    for raw_key, sample_key in spec.field_map.items():
        if raw_key in row:
            out[sample_key] = row[raw_key]
    if spec.task == "nli" and isinstance(out.get("label"), int):
        out["label"] = _NLI_LABELS.get(out["label"], str(out["label"]))
    return out


def _local_jsonl_path(spec: DatasetSpec) -> Optional[Path]:
    root = os.environ.get("SPLADE_RAW_DATA")
    if not root:
        return None
    p = Path(root) / f"{spec.key}.jsonl"
    return p if p.exists() else None


def load_dataset_samples(key: str, limit: int = 0) -> List[RawSample]:
    """Load one registered dataset from local JSONL or the offline HF cache."""
    spec = REGISTRY[key]
    rows: List[Dict[str, Any]] = []
    local = _local_jsonl_path(spec)
    if local is not None:
        with open(local, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
                if limit and len(rows) >= limit:
                    break
        logger.info("loaded %s: %d rows from %s", key, len(rows), local)
    else:
        os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        import datasets

        ds = datasets.load_dataset(spec.hf_name, spec.hf_config, split=spec.split)
        n = min(limit, len(ds)) if limit else len(ds)
        rows = [ds[i] for i in range(n)]
        logger.info("loaded %s: %d rows from HF cache", key, len(rows))
    return [RawSample(source=key, task=spec.task, fields=_map_fields(r, spec))
            for r in rows]
