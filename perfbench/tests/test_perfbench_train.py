"""The table4-qtable-train cell at a small size on the CPU, through the same harness
as on the card (the look for a card skipped): a sound run comes out
correct, a traced run reads the trace, and the timed path broken underneath (the reference in
bfloat16 state in the kernels' place, a launch that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced) comes out not correct."""
import json

import pytest

from perfbench.faults import FAULTS
from perfbench.tests.tiny import run_cell

CELL = "table4-qtable-train"


def test_sound_run_is_correct():
    res = run_cell(CELL, 2**31 + 12345)
    assert res["correct"], res["checks"]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0
    json.dumps(res)


def test_traced_run_reads_the_trace():
    res = run_cell(CELL, 99, trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) >= 1
    assert res["metrics"] == {}          # no device events on the CPU


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(fault):
    res = run_cell(CELL, 31337, fault)
    assert not res["correct"], res["checks"]
