"""Core scheduler of the port: types, timeline, search, admission."""
from repro_torch.core.types import (  # noqa: F401
    ALL_POLICIES,
    Allocation,
    ARRequest,
    BackfillMode,
    Policy,
    Rectangle,
    T_INF,
)
