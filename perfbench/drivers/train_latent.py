"""The training driver of a latent-attention configuration (Kimi K2): the
training driver (``drivers/train.py``) with the port's
:class:`~repro_torch.configs.base.LatentConfig` model in the program's place
and ``reference/train_latent.py`` in the reference's.

The configuration file's ``model`` block holds the base keys and its
``latent`` block the rest; only this driver reads the latter.  Set-up, the
first steps, the window, the traced spans and ``correct``'s readings are
``drivers/train.py``'s, run under :func:`latent_cell`.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from perfbench.drivers import train as train_drv
from perfbench.reference import train as ref_lib
from perfbench.reference import train_latent as ref_latent
from perfbench.yardstick import latent


class Program(train_drv.Program):
    """The port's latent model, AdamW state and train step, and the mix's
    batches on the device."""

    def __init__(self, config: Dict, mix: Dict, seed: int,
                 dev: torch.device):
        from repro_torch.configs.base import LatentConfig
        from repro_torch.models import transformer as tf_lib
        from repro_torch.train import optim as optim_lib
        from repro_torch.train import step as step_lib
        self.spec = latent.LatentSpec.from_config(config)
        self.cfg = LatentConfig(**config["model"], **config["latent"])
        self.mix = mix
        self.opt_cfg = optim_lib.OptConfig(**mix["optimizer"])
        self.params = tf_lib.Transformer(self.cfg, device=dev)
        latent.fill(dict(self.params.named_parameters()), seed,
                    ref_lib.stated_dtype(self.spec))
        self.params.requires_grad_(True)
        self.opt_state = optim_lib.init(self.params, self.opt_cfg)
        self.step_fn = step_lib.make_train_step(self.cfg, self.opt_cfg,
                                                mix["microbatches"])
        self.batches = [train_drv.device_batch(seed, i, self.spec, mix, dev)
                        for i in range(mix["batches"])]
        self.n = 0


def reference_readings(spec: latent.LatentSpec, mix: Dict, seed: int,
                       dev: torch.device, precision: str = "float32") -> Dict:
    """The latent reference's first ``check_steps`` steps from the seed's
    weights and batches."""
    w = {n: torch.empty(s, dtype=torch.float32, device=dev)
         for n, s in ref_latent.leaf_shapes(spec).items()}
    latent.fill(w, seed, ref_lib.stated_dtype(spec))
    batches = [train_drv.device_batch(seed, i, spec, mix, dev)
               for i in range(mix["check_steps"])]
    return ref_latent.run_steps(spec, w, batches, mix["optimizer"], precision)


@contextlib.contextmanager
def latent_cell(config: Dict):
    """``drivers/train.py`` with this configuration's latent program and
    reference in place of its ``Program`` and ``reference_readings`` (its
    ``run`` and ``calibrate.py`` look both up when they call them)."""
    spec = latent.LatentSpec.from_config(config)
    saved = train_drv.Program, train_drv.reference_readings

    def program(model, mix, seed, dev):
        return Program(config, mix, seed, dev)

    def reference(_spec, mix, seed, dev, precision="float32"):
        return reference_readings(spec, mix, seed, dev, precision)
    train_drv.Program, train_drv.reference_readings = program, reference
    try:
        yield
    finally:
        train_drv.Program, train_drv.reference_readings = saved


def run(ctx) -> Dict:
    """One run of a latent training cell; ``ctx`` is the harness's
    resolved cell (see ``perfbench/harness.py``)."""
    with latent_cell(ctx.config):
        return train_drv.run(ctx)
