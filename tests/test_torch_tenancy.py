"""The port's multi-tenant admission against the JAX package and its oracle.

The tenant table of ``repro_torch.tenancy`` rides the one-lane admit
step: the quota gate after the queue work and before the search, the
weighted fair-share order of the deferral queue, overdue reaping, and
the per-tenant accounting and telemetry.  The same numpy-seeded streams
(16 PEs, 300 jobs, 3 tenants; the neutrality matrix at 64 PEs) go
through the reference's ``admit_stream_grow`` (JAX, plain search) and
the port's, and every ``Decision`` field, the records, the queue and
all 17 table fields must agree bit for bit, exact unless stated.

The EWMAs' rounding is pinned to the reference's device path (XLA on
the CPU contracts ``e * (1 - a) + x * a`` into one fused multiply-add):
``acc_ewma`` and ``slow_ewma`` are ``fma(x, a, f32(e * (1 - a)))``,
``occ_ewma`` is ``fma(e, 1 - a, f32(x * a))``.  The port's
``TenantOracle`` rounds the same way, so it equals the port's device
path exactly.  The reference's ``TenantOracle`` rounds all three as
``f32(f64(e) * f64(1 - a) + f64(x) * f64(a))``, so its EWMAs drift from
its own device path's by a few ulps over a stream; against it the
port's oracle is held exact once it rounds the reference oracle's way,
which shows the rounding is the only difference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.core import batch as ref_batch
from repro.core import ensemble as ref_ens
from repro.core import timeline as ref_tl
from repro.core.hostsched import TenantOracle as RefTenantOracle
from repro.core.resources import ResourceSpec as RefResourceSpec
from repro.core.types import ARRequest as RefRequest
from repro.sim import WorkloadParams, generate_filtered
from repro.tenancy import TenantSpec as RefSpec
from repro.tenancy import init_table as ref_init_table
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.api import service as pt_service
from repro_torch.core import batch as pt_batch
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.hostsched import TenantOracle
from repro_torch.core.resources import ResourceSpec
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy, T_INF
from repro_torch.tenancy import (TenantSpec, TenantTable, fair_key,
                                 init_table, snapshot, tenant_view)
from repro_torch.tenancy import table as pt_table

N_PE = 16
SIZES = dict(u_low=2.0, u_med=3.0, u_hi=4.0)
MODES = ("none", "easy", "conservative")
SPEC_KW = dict(weights=(1.0, 4.0, 2.0), quotas=(500.0, None, 800.0),
               max_live=(None, 6, None))
SPEC = TenantSpec(**SPEC_KW)
EWMAS = ("acc_ewma", "slow_ewma", "occ_ewma")


def _workload(n_jobs, seed, load=2.0, n_pe=N_PE, n_tenants=0):
    jobs = generate_filtered(WorkloadParams(
        n_jobs=n_jobs, n_pe=n_pe, seed=seed, arrival_factor=load, **SIZES),
        max_pe=n_pe)
    jobs = sorted(jobs, key=lambda j: j.t_a)
    if n_tenants:
        rng = np.random.default_rng(seed + 1)
        jobs = [dataclasses.replace(j, tenant=int(rng.integers(0, n_tenants)))
                for j in jobs]
    return jobs


def _pt(jobs):
    return [ARRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe, j.tenant,
                      demand=j.demand) for j in jobs]


def _ref(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe, j.tenant,
                       demand=j.demand) for j in jobs]


def _ref_spec(spec):
    return RefSpec(**{f.name: getattr(spec, f.name)
                      for f in dataclasses.fields(spec)})


def _ref_run(jobs, policy, mode, spec, *, Q=8, capacity=64, pending=128,
             n_pe=N_PE, index_tile=None, auto_release=True, rspec=None):
    table = None if spec is None else ref_init_table(_ref_spec(spec),
                                                     pending, Q)
    state = ref_tl.init_state(capacity, n_pe, pending, park_capacity=Q,
                              tenants=table, index_tile=index_tile,
                              rspec=None if rspec is None
                              else RefResourceSpec(rspec.units))
    return ref_batch.admit_stream_grow(
        state, ref_batch.requests_to_batch(
            _ref(jobs), with_tenant=spec is not None,
            extra_demand=0 if rspec is None else rspec.R - 1),
        policy, n_pe=n_pe, backfill=mode, auto_release=auto_release)


def _port_run(jobs, policy, mode, spec, *, Q=8, capacity=64, pending=128,
              n_pe=N_PE, index_tile=None, auto_release=True, rspec=None,
              stats=None):
    table = None if spec is None else init_table(spec, pending, Q, "cpu")
    state = pt_tl.init_state(capacity, n_pe, pending, device="cpu",
                             park_capacity=Q, tenants=table,
                             index_tile=index_tile, rspec=rspec)
    return pt_batch.admit_stream_grow(
        state, pt_batch.requests_to_batch(
            _pt(jobs), "cpu", 0 if rspec is None else rspec.R - 1,
            with_tenant=spec is not None),
        policy, n_pe=n_pe, backfill=mode, auto_release=auto_release,
        stats=stats)


def _ref_arrays(st, keys):
    """The reference state's arrays under the port's state_to_numpy keys."""
    out = {}
    for k in keys:
        if k == "tenants":
            out[k] = {f: np.asarray(getattr(st.tenants, f))
                      for f in st.tenants._fields}
        elif k in ("times", "occ", "idx_occ", "idx_minfree", "idx_maxfree"):
            out[k] = np.asarray(getattr(st.tl, k))
        else:
            out[k] = np.asarray(getattr(st, k))
    return out


def assert_table_equal(got: dict, want: dict):
    assert set(got) == set(want) == set(TenantTable._fields)
    for f in TenantTable._fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert np.asarray(got[f]).dtype == np.asarray(want[f]).dtype, f


def assert_state_equal(port, ref):
    """Every state array, the 17 table fields included, bit for bit."""
    got = pt_tl.state_to_numpy(port)
    want = _ref_arrays(ref, got)
    for k in got:
        if k == "tenants":
            assert_table_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


def assert_decisions_equal(port_dec, ref_dec):
    for f in ref_batch.Decision._fields:
        got = getattr(port_dec, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_dec, f)),
                                      err_msg=f)


def _records(state):
    return [(int(t), frozenset(pt_batch.mask32_to_ids(o)))
            for t, o in zip(state.tl.times.numpy(), state.tl.occ.numpy())
            if t < T_INF]


def _trace(dec):
    return [(bool(a), int(t), bool(p))
            for a, t, p in zip(dec.accepted, dec.t_s, dec.parked)]


def _table(state):
    return {f: getattr(state.tenants, f).numpy()
            for f in TenantTable._fields}


def _strip(entries):
    return [{k: v for k, v in e.items() if k not in ("tenant", "t_a")}
            for e in entries]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these streams are thousands of small ops,
    which extra threads only slow when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec_stream():
    return _workload(300, seed=3, n_tenants=3)


# ---------------------------------------------------------------------------
# neutrality: equal weights and no limits change nothing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def neutral_stream():
    n_pe = 64
    jobs = generate_filtered(WorkloadParams(
        n_jobs=500, n_pe=n_pe, seed=3, arrival_factor=1.0), max_pe=n_pe)
    jobs = sorted(jobs, key=lambda j: j.t_a)
    assert len(jobs) >= 300
    return [dataclasses.replace(j, tenant=i % 3) for i, j in enumerate(jobs)]


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_equal_weight_unlimited_is_identical_to_no_tenants(neutral_stream,
                                                            policy):
    """Every policy and mode, one lane per cell: an all-equal unlimited
    table changes no decision, record, queue entry or counter, and the
    step reads what the tenancy-free step reads."""
    spec = TenantSpec(weights=(1.0, 1.0, 1.0))
    for mode in MODES:
        runs = {}
        for s in (None, spec):
            st = pt_batch.StreamStats()
            out, dec = _port_run(neutral_stream, policy, mode, s, n_pe=64,
                                 capacity=128, pending=256, stats=st)
            runs[s is None] = (out, dec, st)
        (o0, d0, s0), (o1, d1, s1) = runs[True], runs[False]
        for f in pt_batch.Decision._fields:
            assert np.array_equal(getattr(d0, f).numpy(),
                                  getattr(d1, f).numpy()), (mode, f)
        assert _records(o0) == _records(o1), mode
        assert pt_batch.parked_entries(o0) == _strip(
            pt_batch.parked_entries(o1)), mode
        for c in ("n_parked", "n_promoted", "n_moved", "n_released"):
            assert int(getattr(o0, c)) == int(getattr(o1, c)), (mode, c)
        assert s0.host_syncs == s1.host_syncs, mode
        assert o0.tenants is None and o1.tenants is not None


def test_fair_key_reduces_to_fcfs_under_equal_weights():
    """The weighted key with equal weights sorts like FCFS, on the host
    (the oracle's order key) and on the device (``fair_key``)."""
    spec = TenantSpec(weights=(2.5, 2.5, 2.5))
    orc = TenantOracle(N_PE, Policy.FF, "easy", spec)
    t_as = [0, 0, 3, 3, 7]
    entries = [dict(seq=s, tenant=s % 3, t_a=t) for s, t in enumerate(t_as)]
    table = init_table(spec, 8, 5, "cpu")
    table = table._replace(
        park_tenant=table.park_tenant.new_tensor([s % 3 for s in range(5)]),
        park_ta=table.park_ta.new_tensor(t_as))
    for t_now in (7, 10, 100):
        order = sorted(entries, key=lambda p: orc._order_key(p, t_now))
        assert [p["seq"] for p in order] == [0, 1, 2, 3, 4]
        key = fair_key(table, t_now).numpy()
        assert list(np.lexsort((np.arange(5), -key))) == [0, 1, 2, 3, 4]
        assert key.tolist() == [float(np.float32(2.5) * np.float32(t_now - t))
                                for t in t_as]


# ---------------------------------------------------------------------------
# the port against the reference's device path and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", [Policy.FF, Policy.PE_B, Policy.PEDU_W])
def test_device_matches_reference_bit_for_bit(spec_stream, policy, mode):
    """Every Decision field, the records, the queue and all 17 table
    fields equal the reference's device path, the EWMAs included."""
    out, dec = _port_run(spec_stream, policy, mode, SPEC)
    ref_out, ref_dec = _ref_run(spec_stream, policy, mode, SPEC)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    assert pt_batch.parked_entries(out) == ref_batch.parked_entries(ref_out)
    assert int(out.tenants.n_quota_rejected.sum()) > 0


@pytest.mark.parametrize("mode", MODES)
def test_port_oracle_matches_device_and_reference_oracle(spec_stream, mode,
                                                         monkeypatch):
    """The port's ``TenantOracle`` equals the port's device path bit for
    bit, EWMAs included.  Against the reference's oracle the decisions,
    records, queue and every other field are exact, and the EWMAs are
    exact too once the port's oracle rounds them the
    reference oracle's way."""
    for policy in (Policy.FF, Policy.PE_B, Policy.PEDU_W):
        out, dec = _port_run(spec_stream, policy, mode, SPEC)
        orc = TenantOracle(N_PE, policy, mode, SPEC, park_capacity=8)
        ref_orc = RefTenantOracle(N_PE, policy, mode, _ref_spec(SPEC),
                                  park_capacity=8)
        want = [orc.admit(r) for r in _pt(spec_stream)]
        assert _trace(dec) == want, policy
        assert [ref_orc.admit(r) for r in _ref(spec_stream)] == want
        assert _records(out) == orc.records() == ref_orc.records()
        assert pt_batch.parked_entries(out) == orc.pending()
        assert _strip(orc.pending()) == ref_orc.pending()
        snap, ref_snap = orc.accounts.snapshot(), ref_orc.accounts.snapshot()
        table = _table(out)
        for f, v in snap.items():
            np.testing.assert_array_equal(table[f], v, err_msg=f)
            if f not in EWMAS:
                np.testing.assert_array_equal(v, ref_snap[f], err_msg=f)

        def ref_rounding(e, x, a):
            return np.float32(np.float64(e) * np.float64(np.float32(1) - a)
                              + np.float64(x) * np.float64(a))

        with monkeypatch.context() as m:
            m.setattr(pt_table, "ewma_tenant", ref_rounding)
            m.setattr(pt_table, "ewma_occ", ref_rounding)
            one = TenantOracle(N_PE, policy, mode, SPEC, park_capacity=8)
            assert [one.admit(r) for r in _pt(spec_stream)] == want
        for f in EWMAS:
            np.testing.assert_array_equal(one.accounts.snapshot()[f],
                                          ref_snap[f], err_msg=f)


def test_fair_share_changes_promotion_order_and_matches_oracle():
    """A heavy tenant's parked reservation outranks an earlier light one;
    the device still equals the oracle and the reference under skewed
    weights, and the skew changes decisions somewhere."""
    spec = TenantSpec(weights=(1.0, 16.0))
    base = TenantSpec(weights=(1.0, 1.0))
    jobs = _workload(300, seed=9, n_tenants=2)
    diffs = 0
    for policy in (Policy.FF, Policy.PE_B):
        out, dec = _port_run(jobs, policy, "easy", spec)
        orc = TenantOracle(N_PE, policy, "easy", spec, park_capacity=8)
        assert _trace(dec) == [orc.admit(r) for r in _pt(jobs)], policy
        assert _records(out) == orc.records()
        ref_out, ref_dec = _ref_run(jobs, policy, "easy", spec)
        assert_decisions_equal(dec, ref_dec)
        assert_state_equal(out, ref_out)
        flat = _trace(_port_run(jobs, policy, "easy", base)[1])
        diffs += sum(a != b for a, b in zip(_trace(dec), flat))
    assert diffs > 0, "weight skew never changed any decision"


def test_ewma_rounding_is_the_reference_device_paths():
    """On the two-tenant fair-share stream (PE_B, EASY) the pinned fma
    forms give the reference's device EWMAs exactly; two roundings
    (``f32(f32(e * (1 - a)) + f32(x * a))``) miss ``slow_ewma`` by one
    ulp, and the reference oracle's single rounding of the exact sum
    misses both per-tenant EWMAs."""
    spec = TenantSpec(weights=(1.0, 16.0))
    jobs = _pt(_workload(300, seed=9, n_tenants=2))
    ref_out, _ = _ref_run(jobs, Policy.PE_B, "easy", spec)
    want = {f: np.asarray(getattr(ref_out.tenants, f)) for f in EWMAS}
    one = np.float32(1)

    def two(e, x, a):
        return np.float32(np.float32(e * (one - a)) + np.float32(x * a))

    def exact(e, x, a):
        return np.float32(np.float64(e) * np.float64(one - a)
                          + np.float64(x) * np.float64(a))

    def ewmas(tenant_form=None, occ_form=None):
        with pytest.MonkeyPatch.context() as m:
            if tenant_form is not None:
                m.setattr(pt_table, "ewma_tenant", tenant_form)
            if occ_form is not None:
                m.setattr(pt_table, "ewma_occ", occ_form)
            orc = TenantOracle(N_PE, Policy.PE_B, "easy", spec,
                               park_capacity=8)
            for r in jobs:
                orc.admit(r)
        return {f: np.asarray(orc.accounts.snapshot()[f]) for f in EWMAS}

    pinned = ewmas()
    for f in EWMAS:
        np.testing.assert_array_equal(pinned[f], want[f], err_msg=f)
    twice = ewmas(tenant_form=two)
    np.testing.assert_array_equal(twice["acc_ewma"], want["acc_ewma"])
    assert not np.array_equal(twice["slow_ewma"], want["slow_ewma"])
    np.testing.assert_array_max_ulp(twice["slow_ewma"], want["slow_ewma"],
                                    maxulp=1)
    mimic = ewmas(tenant_form=exact, occ_form=exact)
    for f in ("acc_ewma", "slow_ewma"):
        assert not np.array_equal(mimic[f], want[f]), f


def test_easy_head_is_the_highest_key_entry():
    """Under EASY displacement the protected head is the entry with the
    highest fair-share key, not the first in FCFS order: the heavy
    tenant's later reservation keeps its start while the earlier light
    one moves to admit the arrival, as the reference and the oracle do."""
    n_pe = 4
    spec = TenantSpec(weights=(1.0, 16.0))
    jobs = [ARRequest(0, 0, 10, 30, 4, 0),
            ARRequest(1, 1, 5, 40, 4, 0),     # parks at 10: light
            ARRequest(2, 2, 5, 60, 4, 1),     # parks at 15: heavy
            ARRequest(3, 3, 5, 20, 4, 0)]     # needs [10, 15) or [15, 20)
    stats = pt_batch.StreamStats()
    out, dec = _port_run(jobs, Policy.FF, "easy", spec, n_pe=n_pe,
                         stats=stats)
    orc = TenantOracle(n_pe, Policy.FF, "easy", spec, park_capacity=8)
    assert _trace(dec) == [orc.admit(r) for r in jobs]
    ref_out, ref_dec = _ref_run(jobs, Policy.FF, "easy", spec, n_pe=n_pe)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    assert stats.displacements == 1 and bool(dec.accepted[3])
    by_seq = {e["seq"]: e for e in pt_batch.parked_entries(out)}
    # the heavy entry (seq 1) keeps 15; the light FCFS head (seq 0) moved
    assert by_seq[1]["t_s"] == 15 and by_seq[0]["t_s"] != 10
    assert [m[0] for m in orc.moves] == [0]
    flat, _ = _port_run(jobs, Policy.FF, "easy",
                        TenantSpec(weights=(1.0, 1.0)), n_pe=n_pe)
    assert {e["seq"]: e["t_s"] for e in pt_batch.parked_entries(flat)}[0] \
        == 10


# ---------------------------------------------------------------------------
# reaping, sessions, telemetry
# ---------------------------------------------------------------------------


def test_reaping_matches_oracle_and_reference_and_charges_owner():
    spec = TenantSpec(weights=(1.0, 1.0), grace=3)
    jobs = _workload(200, seed=5, n_tenants=2)
    out, dec = _port_run(jobs, Policy.FF, "easy", spec)
    ref_out, _ = _ref_run(jobs, Policy.FF, "easy", spec)
    orc = TenantOracle(N_PE, Policy.FF, "easy", spec, park_capacity=8)
    assert _trace(dec) == [orc.admit(r) for r in _pt(jobs)]
    horizon = max(j.t_a for j in jobs) + 6000
    stats = pt_batch.StreamStats()
    out = pt_batch.reap_until(out, horizon, 3, stats=stats)
    ref_out = ref_batch.reap_until(ref_out, horizon, 3)
    n = orc.reap(horizon)
    assert n > 0 and stats.release_passes > 0
    assert _records(out) == orc.records()
    assert_state_equal(out, ref_out)
    np.testing.assert_array_equal(out.tenants.n_reaped.numpy(),
                                  orc.accounts.n_reaped)
    np.testing.assert_array_equal(out.tenants.live.numpy(), orc.accounts.live)
    assert int(out.tenants.n_reaped.sum()) == n


def test_session_tick_reaps_overdue_reservations():
    spec = TenantSpec(weights=(1.0,), grace=5)
    kw = dict(n_pe=8, capacity=32, chunk_size=4, ring_capacity=8,
              auto_release=False)
    sess = ReservationService(ServiceConfig(tenants=spec, device="cpu",
                                            **kw)).session()
    ref = RefService(RefConfig(tenants=_ref_spec(spec), **kw)).session()
    r = dict(t_a=0, t_r=0, t_du=10, t_dl=20, n_pe=4, tenant=0)
    assert sess.offer([ARRequest(**r)]).n_accepted == 1
    assert ref.offer([RefRequest(**r)]).n_accepted == 1
    assert sess.metrics(tenant=0)["live"] == 1
    for t, n in ((14, 0), (15, 1)):      # t_e + grace = 15
        assert sess.tick(t) == ref.tick(t) == n
    m = sess.metrics(tenant=0)
    assert m["live"] == 0 and m["n_reaped"] == 1
    assert sess.metrics()["reaped"] == ref.metrics()["reaped"] == 1
    assert sess.records() == ref.records() == []
    plain = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    plain.offer([ARRequest(**r)])
    assert plain.tick(100) == 0 and plain.records() != []


def test_metrics_tenant_view_and_errors():
    spec = TenantSpec(weights=(1.0, 2.0), quotas=(100.0, None))
    kw = dict(n_pe=8, capacity=32, chunk_size=4, ring_capacity=8)
    sess = ReservationService(ServiceConfig(tenants=spec, device="cpu",
                                            **kw)).session()
    ref = RefService(RefConfig(tenants=_ref_spec(spec), **kw)).session()
    reqs = [dict(t_a=i, t_r=i, t_du=20, t_dl=i + 40, n_pe=2, tenant=i % 2)
            for i in range(6)]
    sess.offer([ARRequest(**r) for r in reqs])
    ref.offer([RefRequest(**r) for r in reqs])
    for t in (0, 1):
        v, rv = sess.metrics(tenant=t), ref.metrics(tenant=t)
        assert set(v) == set(rv)
        for k in v:
            np.testing.assert_array_equal(v[k], rv[k], err_msg=k)
    snap, ref_snap = sess.metrics()["tenants"], ref.metrics()["tenants"]
    assert set(snap) == set(ref_snap)
    for k in snap:
        np.testing.assert_array_equal(snap[k], ref_snap[k], err_msg=k)
        assert np.asarray(snap[k]).dtype == np.asarray(ref_snap[k]).dtype
    assert snap["n_quota_rejected"][0] > 0
    assert sess.metrics(tenant=0)["weight"] == 1.0
    with pytest.raises(ValueError, match="out of range"):
        sess.metrics(tenant=2)
    plain = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    assert "tenants" not in plain.metrics()
    with pytest.raises(ValueError, match="multi-tenant"):
        plain.metrics(tenant=0)
    with pytest.raises(ValueError, match="out of range"):
        sess.offer([ARRequest(t_a=9, t_r=9, t_du=5, t_dl=30, n_pe=1,
                              tenant=7)])
    table = init_table(spec, 16, 4, "cpu")
    v = tenant_view(snapshot(table), 1)
    assert v["tenant"] == 1 and v["weight"] == 2.0 and v["live"] == 0
    with pytest.raises(ValueError, match="out of range"):
        tenant_view(snapshot(table), 2)


def test_idle_metrics_polls_read_nothing(monkeypatch):
    """An idle ``metrics()`` / ``metrics(tenant=i)`` poll reads nothing
    from the device; a new offer costs one refresh, the table read in
    the same transfer as the other counters."""
    reads = []
    real = pt_service._StreamBackend._refresh_dev_metrics
    monkeypatch.setattr(pt_service._StreamBackend, "_refresh_dev_metrics",
                        lambda self: reads.append(1) or real(self))
    spec = TenantSpec(weights=(1.0, 1.0))
    for backfill in ("none", "easy"):
        sess = ReservationService(ServiceConfig(
            n_pe=8, capacity=32, chunk_size=4, ring_capacity=8,
            tenants=spec, backfill=backfill, device="cpu")).session()
        sess.offer([ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=2)])
        sess.metrics()
        reads.clear()
        syncs = sess._backend.stats.host_syncs
        for _ in range(5):
            sess.metrics()
            sess.metrics(tenant=0)
        assert not reads and sess._backend.stats.host_syncs == syncs
        sess.offer([ARRequest(t_a=5, t_r=5, t_du=10, t_dl=40, n_pe=2,
                              tenant=1)])
        assert sess.metrics()["tenants"]["live"].tolist() == [1, 1]
        assert reads == [1]


def test_growth_preserves_tenant_accounting():
    spec = TenantSpec(weights=(1.0, 1.0), quotas=(None, None))
    jobs = _workload(400, seed=2, n_tenants=2)
    small, d_small = _port_run(jobs, Policy.FF, "easy", spec, capacity=8,
                               pending=8)
    big, d_big = _port_run(jobs, Policy.FF, "easy", spec, capacity=512,
                           pending=512)
    assert _trace(d_small) == _trace(d_big)
    t0, t1 = _table(small), _table(big)
    for f in TenantTable._fields:
        if f != "pend_tenant":
            np.testing.assert_array_equal(t0[f], t1[f], err_msg=f)
    pend = t0["pend_tenant"]
    assert pend.shape[0] == small.pending_capacity
    assert ((pend >= -1) & (pend < 2)).all()
    assert sorted(pend[pend >= 0].tolist()) == sorted(
        t1["pend_tenant"][t1["pend_tenant"] >= 0].tolist())


def test_tenant_config_validation():
    spec = TenantSpec(weights=(1.0, 1.0))
    for kw, match in (
            (dict(n_partitions=2, auto_release=False, chunk_size=None,
                  tenants=(spec, spec)), "share one tenant spec"),
            (dict(lanes=3, chunk_size=4, ring_capacity=8,
                  tenants=(spec, spec)), "tenant specs for"),
            (dict(lanes=2, chunk_size=4, ring_capacity=8,
                  tenants=(spec, "notaspec")), "TenantSpec or None"),
            (dict(chunk_size=4, ring_capacity=8, tenants="gold"),
             "must be a TenantSpec"),
            (dict(engine="host", tenants=spec), "engine='device'"),
            (dict(pending_capacity=4, chunk_size=4, ring_capacity=8,
                  tenants=TenantSpec(weights=(1.0,) * 8)),
             "pending-queue size"),
            (dict(machine_sizes=(6,), tenants=spec), "machine_sizes")):
        ref_kw = dict(kw)
        if isinstance(kw["tenants"], TenantSpec):
            ref_kw["tenants"] = _ref_spec(kw["tenants"])
        elif isinstance(kw["tenants"], tuple):
            ref_kw["tenants"] = tuple(_ref_spec(s) if isinstance(
                s, TenantSpec) else s for s in kw["tenants"])
        with pytest.raises(ValueError, match=match):
            RefConfig(n_pe=8, **ref_kw)
        with pytest.raises(ValueError, match=match):
            ServiceConfig(n_pe=8, **kw)
    for kw, match in ((dict(over_quota="park"), "over_quota"),
                      (dict(weights=()), "weights"),
                      (dict(weights=(1.0,), quotas=(1.0, 2.0)), "quotas"),
                      (dict(weights=(0.0,)), "weights"),
                      (dict(grace=-1), "grace"),
                      (dict(ewma_alpha=0.0), "ewma_alpha")):
        with pytest.raises(ValueError, match=match):
            RefSpec(**kw)
        with pytest.raises(ValueError, match=match):
            TenantSpec(**kw)
    # per-lane tuples run (A12); partitions gate at the router (A15),
    # as the reference's do
    part = ReservationService(ServiceConfig(
        n_pe=8, n_partitions=2, auto_release=False, chunk_size=None,
        tenants=spec, device="cpu")).session()
    ref_part = RefService(RefConfig(
        n_pe=8, n_partitions=2, auto_release=False, chunk_size=None,
        tenants=_ref_spec(spec))).session()
    jobs = [ARRequest(t_a=i, t_r=i, t_du=10, t_dl=i + 40, n_pe=3,
                      tenant=i % 2) for i in range(6)]
    got = part.offer(jobs).allocations()
    want = ref_part.offer(_ref(jobs)).allocations()
    assert [a and (a.t_s, a.pe_ids) for a in got] == \
        [a and (a.t_s, a.pe_ids) for a in want]
    snap, ref_snap = part.metrics()["tenants"], ref_part.metrics()["tenants"]
    for f, v in ref_snap.items():
        np.testing.assert_array_equal(snap[f], np.asarray(v), err_msg=f)
    for kw, lanes in ((dict(tenants=(spec,)), 1),
                      (dict(lanes=2, tenants=(spec, None)), 2)):
        cfg = ServiceConfig(n_pe=8, device="cpu", **kw)
        assert cfg.tenancy and cfg.lane_tenant_specs == kw["tenants"]
        m = ReservationService(cfg).session().metrics()
        assert m["lanes"] == lanes and m["tenants"]["weight"].shape[-1] == 2
    assert not ServiceConfig(n_pe=8, lanes=2, tenants=(None, None)).tenancy
    cfg = ServiceConfig(n_pe=8, tenants=spec, backfill="easy")
    assert cfg.tenancy and not ServiceConfig(n_pe=8).tenancy
    padded = TenantSpec(weights=(1.0, 2.0), quotas=(5.0, None)).padded(4)
    ref_padded = RefSpec(weights=(1.0, 2.0), quotas=(5.0, None)).padded(4)
    assert padded.weights == ref_padded.weights
    np.testing.assert_array_equal(padded.quota_array(),
                                  ref_padded.quota_array())
    np.testing.assert_array_equal(padded.max_live_array(),
                                  ref_padded.max_live_array())


# ---------------------------------------------------------------------------
# gated requests on the index and without auto-release; R = 4; hand-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "easy"])
def test_gated_requests_on_an_indexed_timeline(spec_stream, mode):
    """The index's early reject of a gated request is the rewritten
    request's (always a reject: it asks for n_pe + 1 PEs), and every
    field equals the reference's; the gate rides on the release reads,
    so the step reads what the index-free step reads."""
    jobs = spec_stream[:150]
    stats, plain = pt_batch.StreamStats(), pt_batch.StreamStats()
    out, dec = _port_run(jobs, Policy.PE_B, mode, SPEC, index_tile=16,
                         stats=stats)
    ref_out, ref_dec = _ref_run(jobs, Policy.PE_B, mode, SPEC,
                                index_tile=16)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    assert int(out.tenants.n_quota_rejected.sum()) > 0
    assert stats.early_rejects >= int(out.tenants.n_quota_rejected.sum())
    _port_run(jobs, Policy.PE_B, mode, SPEC, stats=plain)
    assert stats.host_syncs == plain.host_syncs


def test_gated_requests_without_auto_release(spec_stream):
    """With ``auto_release=False`` the ledger is kept (reaping and
    cancels need it) and the gate is the step's one read."""
    jobs = spec_stream[:150]
    stats = pt_batch.StreamStats()
    out, dec = _port_run(jobs, Policy.FF, "none", SPEC, Q=0,
                         auto_release=False, stats=stats)
    ref_out, ref_dec = _ref_run(jobs, Policy.FF, "none", SPEC, Q=0,
                                auto_release=False)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    assert int(out.tenants.n_quota_rejected.sum()) > 0
    assert int((out.pend_te != T_INF).sum()) == int(out.tenants.live.sum())
    # per attempt: the batch, one gate read a step, the latch; and the
    # two high-water marks per growth
    assert stats.host_syncs == (2 + len(jobs)) * (stats.growths + 1) \
        + 2 * stats.growths


def test_r4_tenanted_stream_matches_reference():
    units = (16, 4, 2, 8)
    rng = np.random.default_rng(7)
    jobs = [dataclasses.replace(j, demand=(j.n_pe,) + tuple(
        int(rng.integers(0, u + 1)) for u in units[1:]))
        for j in _workload(200, seed=4, n_tenants=3)]
    spec = ResourceSpec(units)
    for mode in ("none", "easy"):
        out, dec = _port_run(jobs, Policy.PE_W, mode, SPEC, rspec=spec)
        ref_out, ref_dec = _ref_run(jobs, Policy.PE_W, mode, SPEC,
                                    rspec=spec)
        assert_decisions_equal(dec, ref_dec)
        assert_state_equal(out, ref_out)
        assert int(out.tenants.n_quota_rejected.sum()) > 0


def test_state_from_the_reference_continues_alike(spec_stream):
    """A tenanted reference state crosses to the port half-way through
    (``state_from_numpy`` with its table), and the next 50 decisions and
    the whole state agree."""
    first, second = spec_stream[:150], spec_stream[150:200]
    ref_half, _ = _ref_run(first, Policy.PE_B, "easy", SPEC)
    keys = set(pt_tl.state_to_numpy(_port_run(first[:1], Policy.PE_B,
                                               "easy", SPEC)[0]))
    port_half = pt_tl.state_from_numpy(_ref_arrays(ref_half, keys),
                                       device="cpu")
    assert_state_equal(port_half, ref_half)
    ref_end, ref_dec = ref_batch.admit_stream_grow(
        ref_half, ref_batch.requests_to_batch(_ref(second), with_tenant=True),
        Policy.PE_B, n_pe=N_PE, backfill="easy")
    port_end, dec = pt_batch.admit_stream_grow(
        port_half, pt_batch.requests_to_batch(_pt(second), "cpu",
                                              with_tenant=True),
        Policy.PE_B, n_pe=N_PE, backfill="easy")
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(port_end, ref_end)


def test_cancels_return_ownership_as_the_reference_does(spec_stream):
    """``cancel_one`` / ``cancel_many`` on both buffers clear the owner
    and drop its live count, as the reference's steps do."""
    jobs = spec_stream[:200]        # one parked, four pending here
    out, dec = _port_run(jobs, Policy.PE_W, "easy", SPEC)
    ref_out, _ = _ref_run(jobs, Policy.PE_W, "easy", SPEC)
    parked = pt_batch.parked_entries(out)
    assert parked
    pend = [i for i in np.flatnonzero(out.pend_te.numpy() < T_INF)][:3]
    entries = [(p["t_s"], p["t_e"], p["pe_ids"]) for p in parked[:1]] + [
        (int(out.pend_ts[i]), int(out.pend_te[i]),
         pt_batch.mask32_to_ids(out.pend_mask[i])) for i in pend]
    W = out.tl.words
    ts, te, ids = entries[0]
    one, ok = pt_batch.cancel_one(out, ts, te,
                                  pt_tl.ids_to_mask32(ids, W, device="cpu"))
    ref_one, ref_ok = ref_batch.cancel_one(
        ref_out, ts, te, ref_tl.ids_to_mask32(ids, W))
    assert ok and ref_ok
    assert_state_equal(one, ref_one)
    many, done = pt_batch.cancel_many(one, [
        (a, b, pt_tl.ids_to_mask32(c, W, device="cpu"))
        for a, b, c in entries[1:]])
    ref_many, ref_done = ref_batch.cancel_many(ref_one, [
        (a, b, ref_tl.ids_to_mask32(c, W)) for a, b, c in entries[1:]])
    assert done == ref_done == [True] * len(entries[1:])
    assert_state_equal(many, ref_many)
    assert int(many.tenants.live.sum()) == int(out.tenants.live.sum()) - len(
        entries)


# ---------------------------------------------------------------------------
# ensemble lanes with their own tables; the grid's tenant-mix axis
# ---------------------------------------------------------------------------


def test_ensemble_lane_tables_and_reaping():
    """Per-lane tables padded to the widest spec, per-lane grace (the
    spec-less lane never reaps), telemetry stacked ``[E, T]``, all as
    the reference's."""
    spec0 = TenantSpec(weights=(1.0, 1.0), grace=4)
    spec1 = TenantSpec(weights=(1.0,))
    kw = dict(n_pe=8, lanes=2, capacity=32, chunk_size=4, ring_capacity=8,
              auto_release=False)
    ours = ReservationService(ServiceConfig(
        tenants=(spec0, spec1), device="cpu", **kw)).session()
    theirs = RefService(RefConfig(tenants=(_ref_spec(spec0),
                                           _ref_spec(spec1)), **kw)).session()
    r0 = ARRequest(t_a=0, t_r=0, t_du=6, t_dl=20, n_pe=4, tenant=1)
    r1 = ARRequest(t_a=0, t_r=0, t_du=6, t_dl=20, n_pe=4, tenant=0)
    ours.offer([[r0], [r1]])
    theirs.offer([_ref([r0]), _ref([r1])])
    m = ours.metrics()
    assert m["tenants"]["live"].tolist() == [[0, 1], [1, 0]]
    for t, n in ((9, 0), (10, 1)):
        assert ours.tick(t) == theirs.tick(t) == n
    m, rm = ours.metrics(), theirs.metrics()
    assert m["tenants"]["live"].tolist() == [[0, 0], [1, 0]]
    assert m["tenants"]["n_reaped"].tolist() == [[0, 1], [0, 0]]
    assert m["reaped"] == rm["reaped"] == 1
    for f, v in rm["tenants"].items():
        np.testing.assert_array_equal(m["tenants"][f], np.asarray(v),
                                      err_msg=f)
        assert m["tenants"][f].dtype == np.asarray(v).dtype, f
    v = ours.metrics(tenant=1)
    assert v["live"].tolist() == [0, 0] and v["occ_ewma"].shape == (2,)
    with pytest.raises(ValueError, match="lane 1's TenantSpec"):
        ours.offer([[], [r0]])


@pytest.mark.parametrize("donate", [False, True])
def test_ensemble_tenanted_lanes_match_reference(spec_stream, donate):
    """Three pipelined lanes (the spec under EASY, no table, the spec
    with equal weights under none) through offers and ticks: decisions
    and every lane's 17 table fields as the reference's ensemble."""
    ref_spec = _ref_spec(SPEC)
    eq = dataclasses.replace(SPEC, weights=(1.0,) * SPEC.n_tenants)
    kw = dict(n_pe=N_PE, lanes=3, capacity=32, pending_capacity=64,
              chunk_size=16, ring_capacity=64, backfill=("easy", "none",
                                                         "none"),
              donate=donate)
    ours = ReservationService(ServiceConfig(
        tenants=(SPEC, None, eq), device="cpu", **kw)).session()
    theirs = RefService(RefConfig(tenants=(ref_spec, None, _ref_spec(eq)),
                                  **kw)).session()
    jobs = spec_stream[:90]
    bare = [dataclasses.replace(j, tenant=0) for j in jobs]
    for lo, hi in ((0, 40), (40, 90)):
        res = ours.offer([jobs[lo:hi], bare[lo:hi], jobs[lo:hi]])
        ref_res = theirs.offer([_ref(jobs[lo:hi]), _ref(bare[lo:hi]),
                                _ref(jobs[lo:hi])])
        assert_decisions_equal(res.decision, ref_res.decision)
        t = jobs[hi - 1].t_a
        assert ours.tick(t) == theirs.tick(t)
    for e, (st, ref_st) in enumerate(zip(
            ours._backend.states, [ref_ens.member(
                theirs._backend.states, i) for i in range(3)])):
        assert_state_equal(st, ref_st)
        assert ours.pending(e) == theirs.pending(e)
    m, rm = ours.metrics(), theirs.metrics()
    for k in ("accepted", "growths", "n_parked", "n_parked_now",
              "n_promoted", "n_moved", "released"):
        assert m[k] == rm[k], k


def test_simulate_grid_tenant_mix_axis():
    """The grid's tenant-mix axis against the reference's grid: cells
    exact, cross-checked against the port's TenantOracle; the quota mix
    bites somewhere and the ``None`` mix equals the legacy grid."""
    from repro.sim import GridSpec as RefGridSpec
    from repro.sim import simulate_grid as ref_simulate_grid
    from repro.core.types import Policy as RefPolicy
    from repro_torch.sim import GridSpec, simulate_grid

    mix = TenantSpec(weights=(1.0, 3.0), quotas=(4000.0, None))
    kw = dict(arrival_factors=(1.0,), seeds=(0,), flex_factors=(3.0,),
              backfill_modes=("none", "easy"), n_pe=64, n_jobs=100)
    res = simulate_grid(GridSpec(policies=(Policy.FF, Policy.PE_B),
                                 tenant_mixes=(None, mix), **kw),
                        cross_check=True, record_decisions=True,
                        device="cpu")
    ref = ref_simulate_grid(RefGridSpec(
        policies=(RefPolicy.FF, RefPolicy.PE_B),
        tenant_mixes=(None, _ref_spec(mix)), **kw), record_decisions=True)
    assert res.acceptance.shape == ref.acceptance.shape == (2, 2, 1, 1, 1, 2)
    np.testing.assert_array_equal(res.n_accepted, ref.n_accepted)
    np.testing.assert_array_equal(res.n_jobs, ref.n_jobs)
    np.testing.assert_allclose(res.acceptance, ref.acceptance, rtol=1e-6)
    np.testing.assert_allclose(res.slowdown, ref.slowdown, rtol=1e-6)
    assert res.decisions == ref.decisions
    legacy = simulate_grid(GridSpec(policies=(Policy.FF, Policy.PE_B), **kw),
                           device="cpu")
    assert legacy.acceptance.shape == (2, 2, 1, 1, 1)
    np.testing.assert_array_equal(res.acceptance[..., 0], legacy.acceptance)
    assert (res.acceptance[..., 1] < res.acceptance[..., 0]).any()


@pytest.mark.parametrize("tenants", [None, "lanes"])
def test_idle_metrics_polls_read_nothing_on_ensembles(monkeypatch, tenants):
    """The ``lanes=2`` case: an idle poll of an ensemble session reads
    nothing; a new offer costs one refresh (every lane's table in one
    transfer)."""
    reads = []
    real = pt_service._EnsembleBackend._refresh_dev_metrics
    monkeypatch.setattr(pt_service._EnsembleBackend, "_refresh_dev_metrics",
                        lambda self: reads.append(1) or real(self))
    spec = TenantSpec(weights=(1.0, 1.0))
    sess = ReservationService(ServiceConfig(
        n_pe=8, lanes=2, capacity=32, chunk_size=4, ring_capacity=8,
        backfill=("easy", "none"), device="cpu",
        tenants=None if tenants is None else (spec, None))).session()
    reqs = [ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=2)]
    sess.offer([reqs, reqs])
    sess.metrics()
    reads.clear()
    syncs = sess._backend.stats.host_syncs
    for _ in range(5):
        sess.metrics()
        if tenants:
            sess.metrics(tenant=0)
    assert not reads and sess._backend.stats.host_syncs == syncs
    later = [ARRequest(t_a=5, t_r=5, t_du=10, t_dl=40, n_pe=2)]
    sess.offer([later, later])
    m = sess.metrics()
    assert reads == [1] and m["n_parked_now"] >= 0
    if tenants:
        assert m["tenants"]["live"].tolist() == [[2, 0], [2, 0]]
    sess.metrics()
    assert reads == [1]
