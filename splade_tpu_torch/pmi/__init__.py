"""PMI analysis of synonym and expansion pairs (a copy of
``splade_tpu/pmi/``): co-occurrence counts, PMI / PPMI / NPMI and the
synonym validator, on the host (scipy CSR)."""

from splade_tpu_torch.pmi.cooccurrence import CooccurrenceBuilder, CooccurrenceMatrix
from splade_tpu_torch.pmi.pmi_calculator import PMICalculator, PPMICalculator, compute_npmi
from splade_tpu_torch.pmi.synonym_validator import SynonymValidator, ValidationResult

__all__ = [
    "CooccurrenceBuilder",
    "CooccurrenceMatrix",
    "PMICalculator",
    "PPMICalculator",
    "compute_npmi",
    "SynonymValidator",
    "ValidationResult",
]
