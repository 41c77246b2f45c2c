"""PyTorch + CUDA port of the advance-reservation scheduler.

The paper's strict arrival-order admission loop on one machine: the
packed availability timeline (:mod:`repro_torch.core.timeline`, with
one bitplane per resource on multi-resource machines,
:mod:`repro_torch.core.resources`), Algorithm 3's candidate search
(:mod:`repro_torch.core.search`), the fused admit step and its stream
loop (:mod:`repro_torch.core.batch`), the reservation service's
single-lane sessions (:mod:`repro_torch.api`) and the Section 6
simulator (:mod:`repro_torch.sim`).  The search's availability scan
runs in hand-written CUDA kernels (:mod:`repro_torch.kernels`) on the
card; tensors on the CPU take the kernels' plain PyTorch versions.

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller asks for ``"cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
