"""On the card: the cell's whole run at a small size, traced and not,
and the control against the sound run. Run there as

    python -m pytest benchmark/tests -q -m cuda
"""

import pytest
import torch

from benchmark import run
from benchmark.reference import als as ref_als
from benchmark.reference.rounding import lower
from benchmark.runners import als
from benchmark.tests.test_benchmark_reference import small

pytestmark = pytest.mark.cuda

CELLS = ["als-ml20m.train"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_card(card, cell, trace):
    c = small(cell)
    torch.cuda.reset_peak_memory_stats()
    result, _ = run.execute(c, 2**31 + 5, 1.0, trace, device="cuda")
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
        assert len(result["breakdown"]["idle_gaps"]) <= 10
        for m in c.per_layer:
            v = result["metrics"][m["name"]]["value"]
            assert v > 0
            if m["unit"] == "%":
                assert v <= 105
    else:
        assert result["attempted"] >= 1
        assert all(v["value"] > 0 for v in result["metrics"].values())


def worst_ratio(control: dict, sound: dict) -> float:
    return max(control[k] / max(sound[k], 1e-12) for k in sound)


def test_control_reads_far_above_a_sound_run_als(card):
    c = small("als-ml20m.train")
    m = c.config["model"]
    s = als.Setup(m, c.mix, 41, "cuda")
    t, f = s.training()
    del t
    R = s.ratings()
    base = ref_als.train(R, s.X0, s.Y0, m)
    sound = s.judge(f, R, base)
    got = ref_als.train(R, s.X0, s.Y0, m, lower(m["compute_dtype"]))
    control = ref_als.check(R, s.X0, s.Y0, *got, m, base)
    assert worst_ratio(control, sound) > 3
