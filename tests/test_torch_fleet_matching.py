"""The port's batched fleet ingress against the sequential oracle and the
JAX package, bit for bit.

Twins of ``tests/test_fleet_matching.py`` on the port's
``PartitionedCore`` (on the CPU), held against the port's
``FleetRoutingOracle``, which is itself held against the reference's.
The ensemble's probe and matcher, and the lanes after the fused matcher
and the grouped commit (filler steps included), are held against the
reference's functions and ``PartitionedCore`` array by array.  The
8-device sharded matcher has no one-device meaning and waits for the
port's meshes.
"""
import numpy as np
import pytest
import torch

from repro.core import batch as ref_batch
from repro.core import ensemble as ref_ens
from repro.core.hostsched import FleetRoutingOracle as RefOracle
from repro.core.types import ARRequest as RefRequest
from repro.runtime.fleet import PartitionedCore as RefCore
from repro_torch.core import batch as pt_batch
from repro_torch.core import ensemble as pt_ens
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.hostsched import FleetRoutingOracle
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy
from repro_torch.runtime.fleet import PartitionedCore

ROUTINGS3 = ("round_robin", "least_loaded", "best_acceptance")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(n, seed, spacing=20, dmin=50, dmax=600, slack=1.0, wmax=30,
         pemax=17):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for _ in range(n):
        t += int(rng.integers(0, spacing))
        dur = int(rng.integers(dmin, dmax))
        r = t + int(rng.integers(0, wmax))
        t_dl = r + int(dur * (1.0 + slack * rng.random()))
        reqs.append(ARRequest(t_a=t, t_r=r, t_du=dur, t_dl=t_dl,
                              n_pe=int(rng.integers(1, pemax))))
    return reqs


def _ref(reqs):
    return [RefRequest(r.t_a, r.t_r, r.t_du, r.t_dl, r.n_pe) for r in reqs]


def _key(a):
    return None if a is None else (a.t_s, a.t_e, tuple(a.pe_ids))


def _core(n_chips, n_parts, **kw):
    return PartitionedCore(n_chips, n_parts, device="cpu", **kw)


def _assert_matches_oracle(n_chips, n_parts, reqs, policy, routing,
                           capacity=64, match_rounds=8):
    # match_rounds=8 forces the probe/match/commit rounds protocol (auto
    # mode goes straight to the fused matcher); None covers the auto path
    core = _core(n_chips, n_parts, capacity=capacity,
                 match_rounds=match_rounds)
    got = core.admit_stream_allocations(reqs, policy, routing=routing)
    oracle = FleetRoutingOracle(n_chips, n_parts)
    exp = oracle.admit_batch(reqs, policy, routing)
    mism = [i for i in range(len(reqs)) if _key(got[i]) != _key(exp[i])]
    assert not mism, (
        f"{routing}/{policy}: request {mism[0]} got "
        f"{got[mism[0]]} want {exp[mism[0]]}")
    assert core.records() == oracle.records()
    return core


def _ref_arrays(states, keys):
    """The reference's stacked state under the port's state_to_numpy keys."""
    out = {}
    for k in keys:
        if k in ("times", "occ", "idx_occ", "idx_minfree", "idx_maxfree"):
            out[k] = np.asarray(getattr(states.tl, k))
        else:
            out[k] = np.asarray(getattr(states, k))
    return out


def assert_lanes_equal(port, ref):
    """Every lane's every array equals the reference's stacked leaf."""
    got = pt_tl.ensemble_to_numpy(port)
    want = _ref_arrays(ref, got)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def _assert_fields_equal(port, ref):
    """A port Decision or SearchResult against the reference's."""
    for f in type(ref)._fields:
        got = getattr(port, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# the oracle itself, and decision identity against it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ROUTINGS3)
def test_routing_oracle_is_the_reference_oracle(routing):
    reqs = _gen(150, seed=21, slack=0.6)
    for policy in (Policy.FF, Policy.PE_W, Policy.DU_B):
        ours, theirs = FleetRoutingOracle(64, 4), RefOracle(64, 4)
        got = ours.admit_batch(reqs, policy, routing)
        want = theirs.admit_batch(_ref(reqs), policy, routing)
        assert [_key(a) for a in got] == [_key(a) for a in want]
        rect = [(a.rectangle.t_begin, a.rectangle.t_end, a.rectangle.n_free)
                for a in got if a]
        assert rect == [(a.rectangle.t_begin, a.rectangle.t_end,
                         a.rectangle.n_free) for a in want if a]
        assert ours.records() == theirs.records()
        np.testing.assert_array_equal(ours.load, theirs.load)
        assert ours.load.dtype == np.float32
    with pytest.raises(ValueError):
        FleetRoutingOracle(100, 3)
    with pytest.raises(ValueError, match="unknown routing"):
        FleetRoutingOracle(64, 4).admit_batch(reqs[:2], Policy.FF, "nearest")


@pytest.mark.parametrize("routing", ROUTINGS3)
def test_fast_gate_300_jobs_all_routings(routing):
    reqs = _gen(300, seed=3, slack=0.6)
    for policy in (Policy.FF, Policy.PEDU_W):
        _assert_matches_oracle(64, 4, reqs, policy, routing)


def test_fast_gate_auto_rounds_mode():
    """Auto mode is the fused matcher on the card as on one host device
    (the port's probe is searches in turn): 0 rounds, same decisions."""
    reqs = _gen(300, seed=3, slack=0.6)
    for policy in (Policy.FF, Policy.PEDU_W):
        core = _assert_matches_oracle(64, 4, reqs, policy,
                                      "best_acceptance", match_rounds=None)
        assert core.match_max_rounds == 0
        assert core.last_match_rounds == 0


@pytest.mark.slow
def test_slow_gate_1000_jobs_all_policies_all_routings():
    reqs = _gen(1000, seed=17, spacing=10, slack=0.8)
    for routing in ROUTINGS3:
        for policy in ALL_POLICIES:
            _assert_matches_oracle(128, 8, reqs, policy, routing,
                                   capacity=128)


def test_mid_batch_growth_is_decision_invariant():
    """capacity=8 forces the lanes to grow mid-batch; the grown replay
    must reproduce the big-capacity decision sequence."""
    reqs = _gen(120, seed=11, spacing=8, slack=0.8)
    for routing in ROUTINGS3:
        core = _assert_matches_oracle(64, 4, reqs, Policy.FF, routing,
                                      capacity=8)
        assert pt_ens.lane_capacity(core.states)[0] > 8    # actually grew


def test_tight_slack_exercises_rejections():
    reqs = _gen(200, seed=5, slack=0.1, spacing=6)
    core = _assert_matches_oracle(64, 4, reqs, Policy.PE_B,
                                  "best_acceptance")
    assert 0 < core.last_match_rounds <= core.match_max_rounds
    # the reference's rounds protocol takes the same rounds and counts
    # the same dispatches
    ref = RefCore(64, 4, capacity=64, match_rounds=8)
    ref.admit_stream_allocations(_ref(reqs), Policy.PE_B,
                                 routing="best_acceptance")
    assert (core.last_match_rounds, core.dispatches) == \
        (ref.last_match_rounds, ref.dispatches)
    assert_lanes_equal(core.states, ref.states)


# ---------------------------------------------------------------------------
# dispatch complexity: bounded by rounds, never by N
# ---------------------------------------------------------------------------


def test_dispatch_count_constant_in_batch_size():
    counts = {}
    for n in (32, 128):
        core = _core(64, 4, capacity=256, match_rounds=8)
        core.admit_stream_allocations(
            _gen(n, seed=7), Policy.FF, routing="best_acceptance")
        # per round: probe + match + grouped commit; plus one fused
        # tail dispatch (no growth at capacity=256)
        assert core.dispatches <= 3 * core.match_max_rounds + 1, n
        counts[n] = core.dispatches
    assert counts[128] <= 3 * PartitionedCore.match_max_rounds + 1
    # auto mode: the whole batch is one fused matcher dispatch
    core = _core(64, 4, capacity=256)
    core.admit_stream_allocations(_gen(128, seed=7), Policy.FF,
                                  routing="best_acceptance")
    assert core.dispatches <= 3 * PartitionedCore.match_max_rounds + 1
    for routing in ("round_robin", "least_loaded"):
        core = _core(64, 4, capacity=256)
        core.admit_stream_allocations(_gen(128, seed=7), Policy.FF,
                                      routing=routing)
        assert core.dispatches <= 2, routing   # route scan + commit


def test_route_preview_and_legacy_shim():
    core = _core(64, 4, capacity=64)
    reqs = _gen(16, seed=2)
    lanes = core.route(reqs, "best_acceptance")
    assert len(lanes) == 16 and all(-1 <= lane < 4 for lane in lanes)
    # the preview is the reference's
    ref = RefCore(64, 4, capacity=64)
    assert lanes == ref.route(_ref(reqs), "best_acceptance")
    # an impossible request previews as unroutable
    wide = ARRequest(t_a=0, t_r=0, t_du=10, t_dl=20, n_pe=17)
    assert core.route([wide], "best_acceptance") == [-1]
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError):
            core.route(reqs, "best_acceptance", legacy_raise=True)


def test_least_loaded_load_vector_tracks_commits():
    core = _core(64, 4, capacity=64)
    oracle = FleetRoutingOracle(64, 4)
    reqs = _gen(60, seed=9)
    core.admit_stream_allocations(reqs, Policy.FF, routing="least_loaded")
    oracle.admit_batch(reqs, Policy.FF, "least_loaded")
    np.testing.assert_array_equal(np.asarray(core.load, np.float32),
                                  oracle.load)
    ref = RefCore(64, 4, capacity=64)
    ref.admit_stream_allocations(_ref(reqs), Policy.FF,
                                 routing="least_loaded")
    assert core.load == ref.load
    # planned area adds f32(n_pe) * f32(t_du) in float32: at 2**24 and up
    # a float64 sum would route differently
    big = [ARRequest(t_a=0, t_r=0, t_du=2 ** 24 + k, t_dl=2 ** 26, n_pe=3)
           for k in range(1, 6)]
    core.load = [2.0 ** 26] * 4
    ref.load = [2.0 ** 26] * 4
    assert core.route(big, "least_loaded") == ref.route(_ref(big),
                                                        "least_loaded")


# ---------------------------------------------------------------------------
# the ensemble's probe and matcher against the reference's
# ---------------------------------------------------------------------------


def _busy_lanes(index_tile=None, capacity=32):
    """The same four busy 16-PE lanes in both packages."""
    reqs = _gen(48, seed=31, spacing=6, slack=0.5)
    lanes = [i % 4 for i in range(len(reqs))]
    ref = ref_ens.init_ensemble(4, capacity, 16, 64, index_tile=index_tile)
    batch, _, _ = ref_batch.scatter_streams(_ref(reqs), lanes, 4, 16)
    ref, _ = ref_ens.admit_stream_ensemble_auto(
        ref, batch, [Policy.FF] * 4, n_pe=16, auto_release=False)
    port = pt_ens.init_ensemble(4, capacity, 16, 64, index_tile=index_tile,
                                device="cpu")
    batch, _, _ = pt_batch.scatter_streams(reqs, lanes, 4, 16, device="cpu")
    port, _ = pt_ens.admit_stream_ensemble_auto(
        port, batch, [Policy.FF] * 4, n_pe=16, auto_release=False)
    assert_lanes_equal(port, ref)
    return port, ref, reqs[-1].t_a


@pytest.mark.parametrize("index_tile", [None, 8])
def test_probes_equal_the_reference(index_tile):
    port, ref, t0 = _busy_lanes(index_tile)
    probes = _gen(20, seed=32, slack=0.4)
    probes = [ARRequest(t_a=t0 + r.t_a, t_r=t0 + r.t_r, t_du=r.t_du,
                        t_dl=t0 + r.t_dl, n_pe=r.n_pe) for r in probes]
    probes.append(ARRequest(t_a=t0, t_r=t0, t_du=10, t_dl=t0 + 20, n_pe=17))
    for policy in (Policy.FF, Policy.PE_W, Policy.DU_B):
        pid = ref_ens.policy_ids([policy])[0]
        stats = pt_batch.StreamStats()
        got = pt_ens.find_allocations_ensemble(
            port, pt_batch.requests_to_batch(probes, "cpu"), policy,
            n_pe=16, stats=stats)
        want = ref_ens.find_allocations_ensemble(
            ref, ref_batch.requests_to_batch(_ref(probes)), pid, n_pe=16)
        _assert_fields_equal(got, want)
        assert got.found.shape == (len(probes), 4)
        assert stats.probe_searches + stats.probe_rejects == \
            len(probes) * 4
        assert (stats.probe_rejects > 0) == (index_tile is not None)
        for r in probes[:3] + probes[-1:]:
            one = pt_ens.find_allocation_ensemble(port, r, policy, n_pe=16)
            _assert_fields_equal(one, ref_ens.find_allocation_ensemble(
                ref, ref_batch.request_struct(_ref([r])[0]), pid, n_pe=16))
    empty = pt_ens.find_allocations_ensemble(
        port, pt_batch.requests_to_batch([], "cpu"), Policy.FF, n_pe=16)
    assert empty.found.shape == (0, 4) and empty.pe_mask.shape == (0, 4, 1)


@pytest.mark.parametrize("auto_release,mode,capacity,grows", [
    (False, "none", 64, False), (False, "none", 8, True),
    (True, "none", 8, True), (True, "easy", 16, False)])
def test_fused_matcher_equals_the_reference(auto_release, mode, capacity,
                                            grows):
    """Decisions, lanes and every lane array after the fused matcher:
    filler steps (every unchosen lane, with auto-release) and growth
    from an overflow inside the matcher included."""
    reqs = _gen(80, seed=13, spacing=8, slack=0.8)
    Q = 4 if mode != "none" else 0
    grew = []
    for policy in (Policy.FF, Policy.PEDU_W):
        pid = ref_ens.policy_ids([policy])[0]
        ref, ref_lanes, ref_dec = ref_ens.match_stream_ensemble_auto(
            ref_ens.init_ensemble(4, capacity, 16, 32, Q),
            ref_batch.requests_to_batch(_ref(reqs)), pid, n_pe=16,
            backfills=mode, auto_release=auto_release)
        stats = pt_batch.StreamStats()
        port, lanes, dec = pt_ens.match_stream_ensemble_auto(
            pt_ens.init_ensemble(4, capacity, 16, 32, Q, device="cpu"),
            pt_batch.requests_to_batch(reqs, "cpu"), policy, n_pe=16,
            backfills=mode, auto_release=auto_release, stats=stats)
        np.testing.assert_array_equal(lanes.numpy(), np.asarray(ref_lanes))
        _assert_fields_equal(dec, ref_dec)
        assert_lanes_equal(port, ref)
        grew.append(stats.growths > 0)
        # every request probes every lane not yet latched; with
        # auto-release every lane admits (the filler on the unchosen
        # ones), without it one lane
        runs = len(reqs) * (stats.growths + 1)
        assert stats.probe_searches <= 4 * runs
        assert (stats.probe_searches == 4 * runs) == (stats.growths == 0)
        assert stats.steps == (4 if auto_release else 1) * runs
    assert any(grew) == grows


@pytest.mark.parametrize("routing", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("auto_release", [False, True])
def test_grouped_commit_lanes_equal_the_reference(routing, auto_release):
    """The grouped commit pads short lanes with filler steps; with
    auto-release those run each lane's release and queue work, so the
    lanes are compared whole after every commit."""
    kw = dict(capacity=16, auto_release=auto_release)
    if auto_release:
        kw.update(backfill="easy", park_capacity=4)
    core = _core(64, 4, **kw)
    ref = RefCore(64, 4, **kw)
    reqs = _gen(90, seed=17, spacing=8, slack=0.8)
    for k in range(3):
        piece = reqs[k * 30:(k + 1) * 30]
        got = core.admit_stream_allocations(piece, Policy.FF, routing)
        want = ref.admit_stream_allocations(_ref(piece), Policy.FF, routing)
        assert [_key(a) for a in got] == [_key(a) for a in want]
        assert_lanes_equal(core.states, ref.states)
        assert core.load == ref.load
        if auto_release:
            core.release_until(piece[-1].t_a + 200)
            ref.release_until(piece[-1].t_a + 200)
            assert_lanes_equal(core.states, ref.states)
    assert core.records() == ref.records()
    assert core.dispatches == ref.dispatches


def test_best_acceptance_with_index_is_the_index_free_run():
    reqs = _gen(150, seed=23, spacing=5, slack=0.3)
    for rounds in (None, 8):
        plain = _assert_matches_oracle(64, 4, reqs, Policy.FF,
                                       "best_acceptance", capacity=32,
                                       match_rounds=rounds)
        core = _core(64, 4, capacity=32, match_rounds=rounds, index_tile=8)
        got = core.admit_stream_allocations(reqs, Policy.FF,
                                            routing="best_acceptance")
        exp = FleetRoutingOracle(64, 4).admit_batch(reqs, Policy.FF)
        assert [_key(a) for a in got] == [_key(a) for a in exp]
        assert core.records() == plain.records()
        assert core.stats.probe_rejects > 0
        assert core.last_match_rounds == plain.last_match_rounds
