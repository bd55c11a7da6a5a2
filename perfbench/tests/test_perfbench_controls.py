"""The controls of ``perfbench/control.py`` at a tiny size on the CPU:
the reference put in the program's place one precision step below the
configuration's (fp8 products), and with half of each batch left out,
against the float32 reference on the same inputs. Each comes out not
correct under the cell's own limits, as it does on the card at the cell's
size (PERF.md gives those readings)."""

import pytest

from perfbench import control
from perfbench.core.compare import checks
from perfbench.tests.tiny import tiny_cell

KINDS = {"train_v33": control.v33, "train_mlm_512": control.mlm,
         "serve_postings_1m5": control.search}


def fails(readings: dict, limits: dict) -> bool:
    got = checks(readings, limits)
    return any(c["value"] is not None and c["value"] > c["limit"]
               for c in got.values())


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_controls_come_out_not_correct(cell):
    c = tiny_cell(cell)
    got = KINDS[cell](c, 2 ** 31 + 3, "cpu")
    for name, readings in got.items():
        assert fails(readings, c.traffic["limits"]), (name, readings)
