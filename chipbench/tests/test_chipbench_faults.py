"""Each fault a cell can have, planted under its timed path at a tiny size
on the CPU, makes ``correct`` come out false."""
import pytest

from chipbench import faults
from chipbench.tests import tiny

CASES = [(cell, f) for cell in tiny.CELLS
         for f in faults.APPLIES[tiny.context(cell).traffic["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    res = tiny.run(cell, fault=fault)
    assert not res["correct"], res["checks"]


def test_every_kind_has_the_faults_it_can_have():
    assert set(faults.APPLIES["train"]) >= {"unchanged", "half_batch", "altered"}
    assert all("altered" in v for v in faults.APPLIES.values())
