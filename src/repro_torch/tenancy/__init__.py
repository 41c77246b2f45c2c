"""Multi-tenant admission: quotas, fair share, reaping, telemetry.

- :class:`TenantSpec`: host-side config (``ServiceConfig.tenants``).
- :class:`TenantTable`: device-resident per-tenant state, carried on
  ``SchedulerState.tenants``.
- :class:`HostTenantAccounts`: its numpy mirror for the oracle.
- :func:`snapshot` / :func:`tenant_view`: poll-cheap telemetry.
"""
from repro_torch.tenancy.table import (HostTenantAccounts, TenantSpec,
                                       TenantTable, fair_key, grow_table,
                                       init_table, lane_tables,
                                       stack_tables)
from repro_torch.tenancy.telemetry import snapshot, tenant_view

__all__ = [
    "TenantSpec", "TenantTable", "HostTenantAccounts",
    "init_table", "lane_tables", "stack_tables", "grow_table", "fair_key",
    "snapshot", "tenant_view",
]
