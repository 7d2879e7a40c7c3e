"""A run with its timed path broken underneath comes out not correct:
``run.execute`` on the CPU at a small size (the look for a card is the
only part of a run it skips), with each fault of the cell's runner
(``FAULTS``) planted, judged by the cell's own limits."""

import contextlib

import pytest

from benchmark import run
from benchmark.lib import cells
from benchmark.runners import als
from benchmark.tests.test_benchmark_reference import small

CASES = [("als-ml20m.train", k) for k in als.FAULTS]


@pytest.mark.parametrize("cell,kind", CASES)
def test_a_broken_step_is_not_correct(cell, kind):
    c = small(cell)
    with cells.runner(c.config).FAULTS[kind]():
        result, _ = run.execute(c, 2**31 + 99, 0.5, False, device="cpu")
    assert result["correct"] is False
    assert list(result)[-1] == "checks"
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in result["checks"].values())


@pytest.mark.parametrize("cell", ["als-ml20m.train"])
def test_the_result_line_has_the_contract_keys(cell):
    c = small(cell)
    result, _ = run.execute(c, 3, 0.5, False, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    with contextlib.suppress(KeyError):
        assert result["metrics"]["setup_s"]["value"] > 0
