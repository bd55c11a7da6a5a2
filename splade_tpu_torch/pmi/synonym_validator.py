"""Synonym-pair validation by PMI threshold
(a copy of ``splade_tpu/pmi/synonym_validator.py``).

Reference: src/pmi/synonym_validator.py:117-496 — validates KO-EN synonym
pairs against corpus PMI with configurable OOV strategies (REMOVE/KEEP/
SMOOTH, here 'reject'/'accept'/'smooth'), produces per-pair results,
aggregate stats, and a report.
Used to filter synonym expansion data before training.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from splade_tpu_torch.pmi.pmi_calculator import PMICalculator


@dataclass
class ValidationResult:
    source: str
    target: str
    pmi: Optional[float]
    valid: bool
    reason: str


class SynonymValidator:
    def __init__(
        self,
        pmi_calc: PMICalculator,
        threshold: float = 0.0,
        oov_strategy: str = "reject",  # 'reject' | 'accept' | 'smooth'
    ):
        """OOV strategies mirror the reference (synonym_validator.py:34-39,
        :290-298): 'reject' (REMOVE) fails OOV pairs, 'accept' (KEEP)
        passes them without PMI validation, 'smooth' (SMOOTH) scores them
        with a neutral PMI of 0 and applies the normal threshold."""
        assert oov_strategy in ("reject", "accept", "smooth")
        self.pmi_calc = pmi_calc
        self.threshold = threshold
        self.oov_strategy = oov_strategy

    def validate_pair(self, source: str, target: str) -> ValidationResult:
        pmi = self.pmi_calc.pmi(source, target)
        if pmi is None:
            if self.oov_strategy == "accept":
                return ValidationResult(source, target, None, True, "oov_accepted")
            if self.oov_strategy == "smooth":
                # neutral estimate: OOV pair passes iff threshold <= 0
                return ValidationResult(source, target, 0.0,
                                        0.0 >= self.threshold, "oov_smoothed")
            return ValidationResult(source, target, None, False, "oov_rejected")
        if pmi >= self.threshold:
            return ValidationResult(source, target, pmi, True, "pmi_above_threshold")
        return ValidationResult(source, target, pmi, False, "pmi_below_threshold")

    def validate(self, pairs: Sequence[Tuple[str, str]]) -> List[ValidationResult]:
        return [self.validate_pair(a, b) for a, b in pairs]

    @staticmethod
    def stats(results: Sequence[ValidationResult]) -> Dict[str, float]:
        n = len(results)
        valid = sum(r.valid for r in results)
        oov = sum(1 for r in results if r.reason.startswith("oov"))
        pmis = [r.pmi for r in results if r.pmi is not None]
        return {
            "total": n,
            "valid": valid,
            "valid_rate": valid / n if n else 0.0,
            "oov": oov,
            "mean_pmi": sum(pmis) / len(pmis) if pmis else 0.0,
        }

    def report(self, results: Sequence[ValidationResult],
               path: Optional[str] = None) -> str:
        s = self.stats(results)
        lines = [
            "# Synonym validation report",
            f"- pairs: {s['total']}",
            f"- valid: {s['valid']} ({s['valid_rate']*100:.1f}%)",
            f"- OOV: {s['oov']} (strategy: {self.oov_strategy})",
            f"- mean PMI: {s['mean_pmi']:.3f} (threshold {self.threshold})",
            "",
            "| source | target | PMI | valid | reason |",
            "|---|---|---|---|---|",
        ]
        for r in results[:200]:
            pmi_s = f"{r.pmi:.3f}" if r.pmi is not None else "OOV"
            lines.append(f"| {r.source} | {r.target} | {pmi_s} | {r.valid} | {r.reason} |")
        report = "\n".join(lines)
        if path:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            if p.suffix == ".json":
                # with_suffix('.json') would equal the report path and the
                # JSON dump would overwrite the markdown — keep them apart
                p = p.with_suffix(".md")
            p.write_text(report)
            p.with_suffix(".json").write_text(
                json.dumps([asdict(r) for r in results], ensure_ascii=False))
        return report
