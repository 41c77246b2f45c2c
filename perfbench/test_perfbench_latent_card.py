"""On the card, at the latent cell's own size: the program's first steps pass
the cell's limits and the control (the latent reference in float8 in the
program's place) fails them.  ``calibrate_latent.py`` takes the same
readings over many seeds; ``PERF.md`` gives them.

    python3 -m pytest perfbench -m card
"""
import gc
import sys

import pytest

from perfbench import harness
from perfbench.drivers import train as drv
from perfbench.drivers import train_latent as drv_latent
from perfbench.yardstick import latent

CELL = "kimi-k2-instruct.ft-4k"


@pytest.fixture
def whole_card(card):
    """The card with nothing of an earlier test left on it: pytest keeps
    the last failure's traceback (``sys.last_*``, for post-mortem
    debugging), and with it the failed card test's tensors."""
    import torch
    for name in ("last_type", "last_value", "last_traceback", "last_exc"):
        if hasattr(sys, name):
            setattr(sys, name, None)
    gc.collect()
    torch.cuda.empty_cache()
    return card


@pytest.mark.card
def test_control_fails_where_the_latent_program_passes(whole_card):
    import torch
    card = whole_card
    cell = harness.resolve(CELL)
    mix = cell.mix
    seed = 2 ** 31 + 77
    got = drv.check_steps(drv_latent.Program(cell.config, mix, seed, card))
    torch.cuda.empty_cache()
    spec = latent.LatentSpec.from_config(cell.config)
    want = drv_latent.reference_readings(spec, mix, seed, card)
    control = drv_latent.reference_readings(spec, mix, seed, card, "fp8")
    sound = harness.judge(dict(drv.compare(got, want), nonfinite_losses=0.0),
                          cell.limits)
    low = harness.judge(dict(drv.compare(control, want), nonfinite_losses=0.0),
                        cell.limits)
    assert sound["correct"], sound["checks"]
    assert not low["correct"], low["checks"]
