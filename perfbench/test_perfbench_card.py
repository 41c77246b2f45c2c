"""On the card, at each cell's own size: the program's first steps pass
the cell's limits and the control (the reference in float8 in the
program's place) fails them.  ``calibrate.py`` takes the same readings
over many seeds; ``PERF.md`` gives them.

    python3 -m pytest perfbench -m card
"""
import json

import pytest

from perfbench import harness
from perfbench.drivers import train as drv

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, name):
    import torch
    cell = harness.resolve(name)
    model, mix = cell.config["model"], cell.mix
    seed = 2 ** 31 + 77
    got = drv.check_steps(drv.Program(model, mix, seed, card))
    torch.cuda.empty_cache()
    spec = drv.Spec.from_model(model)
    want = drv.reference_readings(spec, mix, seed, card)
    control = drv.reference_readings(spec, mix, seed, card, "fp8")
    sound = harness.judge(dict(drv.compare(got, want), nonfinite_losses=0.0),
                          cell.limits)
    low = harness.judge(dict(drv.compare(control, want), nonfinite_losses=0.0),
                        cell.limits)
    assert sound["correct"], sound["checks"]
    assert not low["correct"], low["checks"]
