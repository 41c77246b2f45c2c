"""Poll-cheap telemetry snapshots of a device :class:`TenantTable`.

The counters live in the table and are updated inside the admit step,
so nothing is read back per step.  A snapshot is one host read of every
per-tenant field plus ``occ_ewma``: the float32 fields cross as their
int32 bit patterns in the same int32 vector as the counters, so the
values arrive bit for bit.  The service caches the snapshot until the
state changes, so polling an idle session reads nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.tenancy.table import FLOAT_FIELDS, TenantTable

#: Table fields surfaced per tenant by :func:`tenant_view`.
_PER_TENANT = ("weight", "quota", "max_live", "used", "live",
               "n_accepted", "n_rejected", "n_quota_rejected",
               "n_parked", "n_reaped", "acc_ewma", "slow_ewma")

#: Every field a snapshot carries.
SNAPSHOT_FIELDS = _PER_TENANT + ("occ_ewma",)


def pack(table: TenantTable) -> torch.Tensor:
    """int32 vector of every snapshot field, floats as their bits (on
    the table's device; a caller may concatenate it to other values to
    read everything in one transfer)."""
    cols = []
    for f in SNAPSHOT_FIELDS:
        x = getattr(table, f).reshape(-1)
        cols.append(x.view(torch.int32) if x.dtype == torch.float32
                    else x.to(torch.int32))
    return torch.cat(cols)


def unpack(host: np.ndarray, n_tenants: int) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pack` on its host copy."""
    out, k = {}, 0
    for f in SNAPSHOT_FIELDS:
        n = 1 if f == "occ_ewma" else n_tenants
        col = np.array(host[k:k + n], dtype=np.int32)
        k += n
        if f in FLOAT_FIELDS:
            col = col.view(np.float32)
        out[f] = col
    out["occ_ewma"] = np.float32(out["occ_ewma"][0])
    return out


def snapshot(table: TenantTable,
             fetch: Optional[Callable[[torch.Tensor], np.ndarray]] = None
             ) -> Dict[str, np.ndarray]:
    """One host read of every tenant counter.

    ``fetch`` is the device-to-host transfer (default ``.cpu().numpy()``);
    a caller that counts its reads passes its own.
    """
    if fetch is None:
        def fetch(x):
            return x.cpu().numpy()
    return unpack(fetch(pack(table)), table.n_tenants)


def tenant_view(snap: Dict[str, np.ndarray], tenant: int) -> Dict:
    """One tenant's scalar slice of a :func:`snapshot` dict."""
    n = np.asarray(snap["weight"]).shape[-1]
    if not 0 <= tenant < n:
        raise ValueError(f"tenant {tenant} out of range [0, {n})")
    out = {}
    for k in _PER_TENANT:
        col = np.asarray(snap[k])[..., tenant]
        out[k] = col.item() if col.ndim == 0 else col
    out["tenant"] = tenant
    out["occ_ewma"] = snap["occ_ewma"]
    return out
