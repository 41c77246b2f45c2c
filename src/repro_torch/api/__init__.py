"""`repro_torch.api`: the reservation service facade.

One streaming session API over a device timeline::

    from repro_torch.api import ReservationService, ServiceConfig

    svc = ReservationService(ServiceConfig(n_pe=1024,
                                           resources=(1024, 128, 64, 256)))
    session = svc.session()
    result = session.offer(requests)     # fixed-shape chunked admission
    session.tick(now)                    # release due completions
"""
from repro_torch.api.config import (  # noqa: F401
    BACKFILLS,
    ENGINE_NAMES,
    ROUTINGS,
    ServiceConfig,
)
from repro_torch.api.service import (  # noqa: F401
    OfferResult,
    ReservationService,
    Session,
)
