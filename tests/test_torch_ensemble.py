"""The port's ensemble against the JAX package's, lane by lane, bit for bit.

The reference steps E stacked lanes with ``jax.vmap``; the port runs a
tuple of one-lane states one after another.  On the same seeded inputs
every ``Decision`` field and every state array (the reference's stacked
``[E, ...]`` leaves against the port's lanes, ``ensemble_to_numpy``)
must be equal: for every policy, mixed policies, the single step, the
donated path's latched rollback, collective growth when one lane
overflows, release and reaping, and a half-run reference ensemble
carried across with ``ensemble_from_numpy``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import batch as ref_batch
from repro.core import ensemble as ref_ens
from repro.core import timeline as ref_tl
from repro.core.types import ARRequest as RefRequest
from repro.tenancy import TenantSpec as RefSpec
from repro.tenancy import stack_tables as ref_stack_tables
from repro_torch.core import batch as pt_batch
from repro_torch.core import ensemble as pt_ens
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy, T_INF
from repro_torch.tenancy import TenantSpec, lane_tables, stack_tables

N_PE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n=25, n_pe=N_PE, pile=False):
    """Arrival-ordered random stream; ``pile=True`` keeps every
    reservation live at once (forces record and pending overflow)."""
    if pile:
        return [ARRequest(t_a=i, t_r=i, t_du=5000, t_dl=i + 5000, n_pe=1)
                for i in range(n)]
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(0, 25, n))
    jobs = []
    for i in range(n):
        du = int(rng.integers(5, 60))
        tr = int(t[i] + rng.integers(0, 30))
        jobs.append(ARRequest(t_a=int(t[i]), t_r=tr, t_du=du,
                              t_dl=tr + du + int(rng.integers(0, 120)),
                              n_pe=int(rng.integers(1, n_pe + 1)),
                              tenant=i % 2))
    return jobs


def _ref(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe, j.tenant,
                       demand=j.demand) for j in jobs]


def _ref_pad(streams, **kw):
    return ref_batch.pad_streams([_ref(s) for s in streams], N_PE, **kw)


def _pt_pad(streams, **kw):
    return pt_batch.pad_streams(streams, N_PE, device="cpu", **kw)


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


def assert_ensemble_equal(port, ref):
    """Every lane's every array (tenant tables too) equals the
    reference's stacked leaf, dtype included."""
    got = pt_tl.ensemble_to_numpy(port)
    want = _ref_arrays(ref, got)
    for k in got:
        pairs = ([(got[k][f], want[k][f], f"tenants.{f}")
                  for f in got[k]] if k == "tenants"
                 else [(got[k], want[k], k)])
        for a, b, name in pairs:
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name


def assert_decisions_equal(port_dec, ref_dec):
    for f in ref_batch.Decision._fields:
        got = getattr(port_dec, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_dec, f)),
                                      err_msg=f)


def _both(streams, policies, *, capacity=64, pending=32, Q=0, modes=None,
          donate=False, **kw):
    """The same padded streams through both ensembles' auto wrappers."""
    E = len(streams)
    ref_out, ref_dec = ref_ens.admit_stream_ensemble_auto(
        ref_ens.init_ensemble(E, capacity, N_PE, pending, Q),
        _ref_pad(streams)[0], policies, n_pe=N_PE, backfills=modes,
        donate=donate)
    stats = pt_batch.StreamStats()
    out, dec = pt_ens.admit_stream_ensemble_auto(
        pt_ens.init_ensemble(E, capacity, N_PE, pending, Q, device="cpu"),
        _pt_pad(streams)[0], policies, n_pe=N_PE, backfills=modes,
        donate=donate, stats=stats, **kw)
    return (out, dec, stats), (ref_out, ref_dec)


def _independent(stream, policy, capacity=64, pending=32):
    state = pt_tl.init_state(capacity, N_PE, pending, device="cpu")
    return pt_batch.admit_stream_grow(
        state, pt_batch.requests_to_batch(stream, "cpu"), policy, n_pe=N_PE)


@pytest.mark.parametrize("policy", ALL_POLICIES, ids=lambda p: p.value)
def test_ensemble_stream_matches_independent_runs(policy):
    """E lanes under one policy == E independent growing runs == the
    reference's vmapped ensemble."""
    streams = [_stream(s) for s in range(4)]
    (out, dec, _), (ref_out, ref_dec) = _both(streams, [policy] * 4)
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(out, ref_out)
    for i, stream in enumerate(streams):
        lane_state, lane_dec = _independent(stream, policy)
        for f in pt_batch.Decision._fields:
            assert torch.equal(getattr(lane_dec, f), getattr(dec, f)[i]), f
        assert int(lane_state.n_accepted) == int(out[i].n_accepted)


def test_ensemble_mixed_policies_one_call():
    """Every lane runs its own policy: all seven on one workload."""
    stream = _stream(42)
    E = len(ALL_POLICIES)
    (out, dec, _), (ref_out, ref_dec) = _both([stream] * E,
                                              list(ALL_POLICIES))
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(out, ref_out)
    assert pt_ens.policy_ids(ALL_POLICIES) == tuple(
        np.asarray(ref_ens.policy_ids(ALL_POLICIES)).tolist())


@pytest.mark.parametrize("donate", [False, True])
def test_ensemble_overflow_lane_grows_collectively(donate):
    """One lane overflows both the timeline and the pending buffer
    mid-stream, its neighbours do not: the collective re-run leaves
    every lane identical to its independent run and to the reference."""
    streams = [_stream(0, n=14, pile=True), _stream(1, n=14),
               _stream(2, n=14)]
    (out, dec, stats), (ref_out, ref_dec) = _both(
        streams, [Policy.FF] * 3, capacity=8, pending=2, donate=donate)
    cap, pend = pt_ens.lane_capacity(out)
    assert cap > 8 and pend > 2
    assert (cap, pend) == ref_ens.lane_capacity(ref_out)
    assert stats.growths >= 1
    assert not any(bool(s.overflow) for s in out)
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(out, ref_out)
    for i, stream in enumerate(streams):
        _, lane_dec = _independent(stream, Policy.FF)
        assert torch.equal(lane_dec.accepted, dec.accepted[i])
        assert torch.equal(lane_dec.t_s, dec.t_s[i])


def test_ensemble_growth_is_sized_by_watermark(monkeypatch):
    """Growth jumps straight to the worst lane's need, in as many
    rounds and to the same sizes as the reference's."""
    streams = [_stream(0, n=20, pile=True), _stream(1, n=20)]
    calls = {"ours": [], "theirs": []}

    def spy(mod, key):
        real = mod.grow_ensemble

        def grow(states, cap, pend):
            calls[key].append((cap, pend))
            return real(states, cap, pend)
        monkeypatch.setattr(mod, "grow_ensemble", grow)

    spy(pt_ens, "ours")
    spy(ref_ens, "theirs")
    (out, dec, _), (ref_out, ref_dec) = _both(
        streams, [Policy.FF] * 2, capacity=8, pending=4)
    assert len(calls["ours"]) <= 2
    assert calls["ours"] == calls["theirs"]
    assert_decisions_equal(dec, ref_dec)


def test_admit_ensemble_single_step():
    """The single step on every lane: one request per lane."""
    reqs = [ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=k)
            for k in (1, 8, 16)]
    batch = _pt_pad([[r] for r in reqs])[0]
    one = pt_batch.RequestBatch(*(getattr(batch, f)[:, 0]
                                  for f in pt_batch.REQ_FIELDS))
    ref_b = _ref_pad([[r] for r in reqs])[0]
    ref_one = ref_batch.RequestBatch(*(getattr(ref_b, f)[:, 0]
                                       for f in ref_batch.REQ_FIELDS))
    pids = pt_ens.policy_ids([Policy.FF] * 3)
    out, dec = pt_ens.admit_ensemble(
        pt_ens.init_ensemble(3, 32, N_PE, 8, device="cpu"), one, pids,
        n_pe=N_PE)
    ref_out, ref_dec = ref_ens.admit_ensemble(
        ref_ens.init_ensemble(3, 32, N_PE, 8), ref_one,
        ref_ens.policy_ids([Policy.FF] * 3), n_pe=N_PE)
    assert bool(dec.accepted.all())
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(out, ref_out)


def test_ensemble_update_per_lane_equals_reference_vmapped_update():
    """``timeline.update`` on each lane equals the reference's vmapped
    update over the stacked timelines."""
    t_s, t_e = [0, 10, 20], [5, 30, 25]
    masks = [pt_tl.ids_to_mask32(range(k), 1) for k in (4, 16, 1)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[ref_tl.empty(16, N_PE)] * 3)
    ref, ref_ovf = jax.vmap(
        lambda tl, a, b, m: ref_tl.update(tl, a, b, m, is_add=True))(
        stacked, jnp.asarray(t_s, jnp.int32), jnp.asarray(t_e, jnp.int32),
        jnp.asarray(pt_words.to_uint32(torch.stack(masks).numpy())))
    for i in range(3):
        tl, ovf = pt_tl.update(pt_tl.empty(16, N_PE, "cpu"), t_s[i], t_e[i],
                               masks[i], is_add=True)
        assert bool(ovf) == bool(ref_ovf[i])
        np.testing.assert_array_equal(tl.times.numpy(),
                                      np.asarray(ref.times[i]))
        np.testing.assert_array_equal(pt_words.to_uint32(tl.occ.numpy()),
                                      np.asarray(ref.occ[i]))


def test_ensemble_kernel_path_matches_plain_path():
    """``use_kernel`` (the kernels' plain versions on the CPU) decides
    as the plain search path and as the reference."""
    streams = [_stream(s, n=12) for s in range(2)]
    pols = [Policy.PE_W, Policy.DU_B]
    (_, kern, _), (_, ref_dec) = _both(streams, pols, use_kernel=True)
    (_, plain, _), _ = _both(streams, pols, use_kernel=False)
    for f in pt_batch.Decision._fields:
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert_decisions_equal(kern, ref_dec)


def test_donated_latch_rolls_back_every_lane_and_sticks():
    """A latch on one lane returns every lane as it entered, with the
    per-lane latch and max high-water marks of the reference; a second
    call on the latched ensemble changes nothing."""
    streams = [_stream(0, n=12, pile=True), _stream(1, n=12)]
    pids = (0, 0)
    ref_start = ref_ens.init_ensemble(2, 8, N_PE, 4)
    ref_b = _ref_pad(streams)[0]
    ref1, _ = ref_ens.admit_stream_ensemble_donated(
        ref_start, ref_b, jnp.asarray(pids, jnp.int32), n_pe=N_PE)
    start = pt_ens.init_ensemble(2, 8, N_PE, 4, device="cpu")
    b = _pt_pad(streams)[0]
    one, _ = pt_ens.admit_stream_ensemble_donated(start, b, pids,
                                                  n_pe=N_PE)
    assert [bool(s.overflow) for s in one] == [True, False]
    assert_ensemble_equal(one, ref1)
    for s, s0 in zip(one, start):
        assert torch.equal(s.tl.times, s0.tl.times)
        assert int(s.n_accepted) == 0
    two, _ = pt_ens.admit_stream_ensemble_donated(one, _pt_pad(
        [streams[1], streams[1]])[0], pids, n_pe=N_PE)
    ref2, _ = ref_ens.admit_stream_ensemble_donated(
        ref1, _ref_pad([streams[1], streams[1]])[0],
        jnp.asarray(pids, jnp.int32), n_pe=N_PE)
    assert_ensemble_equal(two, ref2)
    grown = pt_ens.grow_rollback_ensemble(two)
    ref_grown = ref_ens.grow_rollback_ensemble(ref2)
    assert_ensemble_equal(grown, ref_grown)


def test_terminal_overflow_raises_with_the_rolled_back_lanes():
    streams = [_stream(0, n=12, pile=True), _stream(1, n=12)]
    start = pt_ens.init_ensemble(2, 8, N_PE, 4, device="cpu")
    with pytest.raises(pt_batch.GrowthError) as exc:
        pt_ens.admit_stream_ensemble_auto(
            start, _pt_pad(streams)[0], [Policy.FF] * 2, n_pe=N_PE,
            max_growths=0, donate=True)
    assert len(exc.value.state) == 2
    assert bool(exc.value.state[0].overflow)
    with pytest.raises(pt_batch.GrowthError) as exc:
        pt_ens.admit_stream_ensemble_auto(
            start, _pt_pad(streams)[0], [Policy.FF] * 2, n_pe=N_PE,
            max_growths=0)
    assert exc.value.state is None


def test_release_and_reap_until_match_reference():
    """Collective release (growing from a tiny timeline) and per-lane
    reaping with one lane's grace at ``T_INF``."""
    streams = [_stream(s, n=20) for s in range(3)]
    horizon = 400
    (out, _, _), (ref_out, _) = _both(streams, [Policy.PE_W] * 3,
                                      capacity=64, pending=32)
    assert_ensemble_equal(pt_ens.release_until_ensemble(out, horizon),
                          ref_ens.release_until_ensemble(ref_out, horizon))
    # reaping: tenanted lanes without auto-release, graces per lane
    specs = (TenantSpec(weights=(1.0, 2.0), grace=7), None,
             TenantSpec(weights=(1.0,), grace=0))
    ref_specs = tuple(None if s is None else RefSpec(
        weights=s.weights, grace=s.grace) for s in specs)
    graces = [7, T_INF, 0]
    st = pt_ens.init_ensemble(3, 64, N_PE, 32, tenants=lane_tables(
        specs, 32, 0, "cpu"), device="cpu")
    ref_st = ref_ens.init_ensemble(3, 64, N_PE, 32)._replace(
        tenants=ref_stack_tables(ref_specs, 32, 0))
    b = _pt_pad(streams, with_tenant=True)[0]
    st, dec = pt_ens.admit_stream_ensemble(st, b, (1, 1, 1), n_pe=N_PE,
                                           auto_release=False)
    ref_st, ref_dec = ref_ens.admit_stream_ensemble(
        ref_st, _ref_pad(streams, with_tenant=True)[0],
        jnp.ones((3,), jnp.int32), n_pe=N_PE, auto_release=False)
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(st, ref_st)
    for t in (150, 300, horizon):
        st = pt_ens.reap_until_ensemble(st, t, graces)
        ref_st = ref_ens.reap_until_ensemble(
            ref_st, t, np.asarray(graces, np.int32))
        assert_ensemble_equal(st, ref_st)
    assert int(st[1].n_released) == 0 and int(st[0].n_released) > 0


def test_half_run_reference_ensemble_continues_alike():
    """A reference ensemble (mixed policies and backfill modes, a
    queue, per-lane tenant tables) crosses to the port half-way through
    with ``ensemble_from_numpy`` and both continue alike."""
    streams = [_stream(s, n=40) for s in range(3)]
    first = [s[:20] for s in streams]
    second = [s[20:] for s in streams]
    pols, modes = [Policy.PE_W, Policy.FF, Policy.DU_B], \
        ("none", "easy", "conservative")
    specs = (TenantSpec(weights=(1.0, 3.0)), None, TenantSpec(
        weights=(2.0, 1.0), quotas=(3000.0, None)))
    ref_specs = tuple(None if s is None else RefSpec(
        weights=s.weights, quotas=s.quotas) for s in specs)
    ref_st = ref_ens.init_ensemble(3, 64, N_PE, 32, park_capacity=4)._replace(
        tenants=ref_stack_tables(ref_specs, 32, 4))
    ref_half, _ = ref_ens.admit_stream_ensemble_auto(
        ref_st, _ref_pad(first, with_tenant=True)[0], pols, n_pe=N_PE,
        backfills=modes)
    keys = set(pt_tl.ensemble_to_numpy(pt_ens.init_ensemble(
        3, 64, N_PE, 32, 4, tenants=lane_tables(specs, 32, 4, "cpu"),
        device="cpu")))
    half = pt_tl.ensemble_from_numpy(_ref_arrays(ref_half, keys),
                                     device="cpu")
    assert_ensemble_equal(half, ref_half)
    ref_end, ref_dec = ref_ens.admit_stream_ensemble_auto(
        ref_half, _ref_pad(second, with_tenant=True)[0], pols, n_pe=N_PE,
        backfills=modes)
    end, dec = pt_ens.admit_stream_ensemble_auto(
        half, _pt_pad(second, with_tenant=True)[0], pols, n_pe=N_PE,
        backfills=modes)
    assert_decisions_equal(dec, ref_dec)
    assert_ensemble_equal(end, ref_end)


def test_lane_helpers_match_reference():
    specs = (TenantSpec(weights=(1.0, 2.0, 3.0)), None,
             TenantSpec(weights=(1.0,), quotas=(50.0,)))
    ref_specs = tuple(None if s is None else RefSpec(
        weights=s.weights, quotas=s.quotas) for s in specs)
    got = stack_tables(specs, 16, 4, "cpu")
    want = ref_stack_tables(ref_specs, 16, 4)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    st = pt_ens.init_ensemble(3, 32, N_PE, 8, device="cpu")
    assert pt_ens.ensemble_size(st) == 3
    assert pt_ens.lane_capacity(st) == (32, 8)
    lane = pt_tl.init_state(32, N_PE, 8, device="cpu")
    st2 = pt_ens.set_member(st, 1, lane)
    assert pt_ens.member(st2, 1) is lane and st2[0] is st[0]
    assert pt_ens.stack_states([lane, lane]) == (lane, lane)
    with pytest.raises(ValueError, match="capacities"):
        pt_ens.stack_states([lane, pt_tl.init_state(64, N_PE, 8,
                                                    device="cpu")])
    for modes in (None, "easy", ("none", "easy", "conservative")):
        assert pt_ens.backfill_ids(modes, 3) == tuple(
            np.asarray(ref_ens.backfill_ids(modes, 3)).tolist())
    grown = pt_ens.grow_ensemble(st, 64, 16)
    assert pt_ens.lane_capacity(grown) == (64, 16)
