"""The port's fleet runtime: twins of ``tests/test_fleet.py`` and
``tests/test_fleet_partition.py``, and a scripted day held against the
JAX package's ``FleetScheduler`` bit for bit.

The twins run on the CPU (``device="cpu"``) with the port's own job
durations, which the roofline prices on the H100.  The comparison with
the reference pins the port's ``estimate_duration`` to the reference's
(TPU) values, so both fleets see the same requests: job tables (state,
start, end, cards, preemptions, partition) and event logs must be equal
on the device engine, the host engine and a partitioned fleet.
"""
import numpy as np
import pytest
import torch

from repro.runtime import FleetScheduler as RefFleet
from repro.runtime import fleet as ref_fleet
from repro_torch.configs import ALL_SHAPES, ARCH_IDS, applicable, get_config
from repro_torch.core.hostsched import FleetRoutingOracle
from repro_torch.core.types import ARRequest, Policy
from repro_torch.runtime import (FleetScheduler, JobState, PartitionedCore,
                                 estimate_duration)
from repro_torch.runtime import fleet as pt_fleet

SPEC = dict(arch="qwen3-4b", shape="train_4k", n_chips=64, n_steps=200)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(**kw):
    return FleetScheduler(device="cpu", **kw)


def _assert_no_double_booking(fleet):
    for t, busy in fleet.core.records():
        assert len(busy) <= fleet.n_chips


@pytest.fixture
def reference_durations(monkeypatch):
    """The port prices jobs as the reference does (TPU durations)."""
    monkeypatch.setattr(pt_fleet, "estimate_duration",
                        ref_fleet.estimate_duration)


def _busy_at(fleet, t):
    busy = set()
    for rt, b in fleet.core.records():
        if rt <= t:
            busy = b
    return busy


# ---------------------------------------------------------------------------
# twins of tests/test_fleet.py
# ---------------------------------------------------------------------------


def test_admission_and_completion():
    f = _fleet(n_chips=512)
    j = f.submit("qwen3-4b", "train_4k", 256, n_steps=500)
    assert j.state == JobState.RESERVED
    assert len(j.chips) == 256
    f.advance(j.t_end + 1)
    assert j.state == JobState.DONE
    assert f.core.records() == []      # everything released


def test_rejection_when_fleet_saturated():
    f = _fleet(n_chips=64)
    jobs = [f.submit("stablelm-1.6b", "train_4k", 64, n_steps=5000,
                     deadline_slack=0.0) for _ in range(4)]
    states = [j.state for j in jobs]
    assert states[0] == JobState.RESERVED
    assert JobState.REJECTED in states  # zero slack forces rejections


def test_chip_failure_migrates_jobs():
    f = _fleet(n_chips=256)
    j = f.submit("granite-moe-1b-a400m", "train_4k", 128, n_steps=2000)
    f.advance(j.t_start + 100)
    failed_chip = j.chips[0]
    migrated = f.fail_chip(failed_chip)
    assert j.job_id in migrated
    assert failed_chip not in j.chips      # moved off the failed card
    assert j.preemptions == 1
    _assert_no_double_booking(f)
    assert failed_chip in _busy_at(f, f.now)   # the repair reservation


def test_failure_respects_checkpoint_granularity():
    f = _fleet(n_chips=128)
    j = f.submit("stablelm-1.6b", "train_4k", 64, n_steps=4000)
    j.checkpoint_interval = 300
    f.advance(j.t_start + 650)          # two checkpoints written
    old_total = j.t_end - j.t_start
    f.fail_chip(j.chips[0])
    # remaining = total - 600 (kept work) + restart overhead
    assert j.t_end - j.t_start == old_total - 600 + f.restart_overhead


def test_straggler_stretches_within_slack():
    f = _fleet(n_chips=128)
    j = f.submit("stablelm-1.6b", "train_4k", 64, n_steps=2000,
                 deadline_slack=3.0)
    f.advance(j.t_start + 10)
    end_before = j.t_end
    assert f.report_straggler(j.job_id, slowdown=1.5)
    assert j.t_end > end_before
    assert j.t_end <= j.deadline
    _assert_no_double_booking(f)


def test_straggler_beyond_slack_fails():
    f = _fleet(n_chips=128)
    j = f.submit("stablelm-1.6b", "train_4k", 64, n_steps=2000,
                 deadline_slack=0.05)
    f.advance(j.t_start + 10)
    assert not f.report_straggler(j.job_id, slowdown=50.0)
    assert j.state == JobState.FAILED


def test_elastic_rescale_changes_footprint():
    f = _fleet(n_chips=512)
    j = f.submit("qwen3-4b", "train_4k", 256, n_steps=1000,
                 deadline_slack=5.0)
    f.advance(j.t_start + 5)
    assert f.rescale(j.job_id, 128)
    assert j.n_chips == 128
    assert len(j.chips) == 128
    _assert_no_double_booking(f)


def test_estimate_duration_scales_with_chips():
    # 10,000 steps: at 100 both footprints sit on the 60 s floor on H100s
    d256 = estimate_duration("qwen3-4b", "train_4k", 256, 10_000)
    d64 = estimate_duration("qwen3-4b", "train_4k", 64, 10_000)
    assert d64 > d256 * 2     # fewer cards -> much longer


def test_policy_affects_placement():
    """FF starts ASAP; PE_W may defer for a larger free rectangle."""
    starts = {}
    for pol in (Policy.FF, Policy.PE_W):
        f = _fleet(n_chips=512, policy=pol)
        f.submit("qwen3-4b", "train_4k", 256, n_steps=2000)
        j2 = f.submit("stablelm-1.6b", "train_4k", 128, n_steps=500,
                      deadline_slack=8.0)
        starts[pol] = j2.t_start
    assert starts[Policy.FF] <= starts[Policy.PE_W]


def test_malleable_submission_picks_earliest_finish():
    """Paper Section 7: malleable requirements translate to a group of
    rigid requests; the earliest feasible finish wins."""
    f = _fleet(n_chips=512)
    f.submit("qwen3-4b", "train_4k", 384, n_steps=2000)
    j = f.submit_malleable("stablelm-1.6b", "train_4k",
                           chip_options=[64, 128, 512], n_steps=1000)
    assert j.state == JobState.RESERVED
    assert j.n_chips in (64, 128)      # 512 cannot start before 384 ends
    _assert_no_double_booking(f)


def test_malleable_rejected_when_nothing_fits():
    f = _fleet(n_chips=64)
    f.submit("stablelm-1.6b", "train_4k", 64, n_steps=50_000,
             deadline_slack=5.0)
    j = f.submit_malleable("stablelm-1.6b", "train_4k",
                           chip_options=[32, 64], n_steps=50_000,
                           deadline=f.now + 100)
    assert j.state == JobState.REJECTED


# ---------------------------------------------------------------------------
# twins of tests/test_fleet_partition.py
# ---------------------------------------------------------------------------


def test_round_robin_spreads_across_partitions():
    f = _fleet(n_chips=256, n_partitions=4)
    jobs = f.submit_batch([dict(SPEC) for _ in range(8)])
    assert all(j.state == JobState.RESERVED for j in jobs)
    assert [j.partition for j in jobs] == [0, 1, 2, 3, 0, 1, 2, 3]
    for j in jobs:
        assert len({c // 64 for c in j.chips}) == 1
    f.advance(max(j.t_end for j in jobs) + 1)
    assert f.core.records() == []


def test_round_robin_lane_matches_single_cluster():
    """Each partition's stream admits as a standalone fleet of the
    partition size would."""
    f = _fleet(n_chips=256, n_partitions=4)
    jobs = f.submit_batch([dict(SPEC) for _ in range(8)])
    solo = _fleet(n_chips=64, engine="device")
    solo_jobs = [solo.submit(**SPEC) for _ in range(2)]
    lane0 = [j for j in jobs if j.partition == 0]
    for mine, ref in zip(lane0, solo_jobs):
        assert mine.state == ref.state
        assert (mine.t_start, mine.t_end) == (ref.t_start, ref.t_end)
        assert tuple(c % 64 for c in mine.chips) == ref.chips


def test_least_loaded_routes_to_idle_partition():
    f = _fleet(n_chips=256, n_partitions=4, routing="least_loaded")
    f.core.add_allocation(0, 10_000_000, list(range(64)))
    jobs = f.submit_batch([dict(SPEC) for _ in range(3)])
    assert all(j.state == JobState.RESERVED for j in jobs)
    assert all(j.partition != 0 for j in jobs)
    assert len({j.partition for j in jobs}) == 3


def test_best_acceptance_probe_avoids_saturated_partition():
    f = _fleet(n_chips=128, n_partitions=2, routing="best_acceptance")
    f.core.add_allocation(0, 10_000_000, list(range(64)))
    jobs = f.submit_batch([dict(SPEC) for _ in range(2)])
    assert all(j.state == JobState.RESERVED for j in jobs)
    assert all(j.partition == 1 for j in jobs)
    assert jobs[1].t_start >= jobs[0].t_end


def test_job_wider_than_partition_rejected():
    f = _fleet(n_chips=256, n_partitions=4)
    j = f.submit("qwen3-4b", "train_4k", 128, n_steps=100)
    assert j.state == JobState.REJECTED


def test_partitioned_fault_tolerance_paths(reference_durations):
    # the reference's slack arithmetic: on H100 durations (208 s here)
    # the straggler's 120 s restart overhead would pass the deadline
    f = _fleet(n_chips=256, n_partitions=4)
    j = f.submit(**SPEC)
    assert j.state == JobState.RESERVED
    f.advance(j.t_start + 100)
    failed = j.chips[0]
    migrated = f.fail_chip(failed)
    assert j.job_id in migrated
    assert failed not in j.chips
    assert j.preemptions == 1
    assert failed in _busy_at(f, f.now)
    assert f.report_straggler(j.job_id, slowdown=1.3)
    assert f.rescale(j.job_id, 32)
    assert j.n_chips == 32
    assert j.partition == j.chips[0] // f.core.chips_per_part


def test_no_double_booking_across_partitions():
    f = _fleet(n_chips=128, n_partitions=2)
    jobs = f.submit_batch([dict(SPEC) for _ in range(6)])
    seen = {}
    for j in jobs:
        if j.state != JobState.RESERVED:
            continue
        for c in j.chips:
            for (t0, t1) in seen.get(c, []):
                assert j.t_end <= t0 or j.t_start >= t1, \
                    f"card {c} double-booked"
            seen.setdefault(c, []).append((j.t_start, j.t_end))
    _assert_no_double_booking(f)


def test_partitioned_core_validates_arguments():
    with pytest.raises(ValueError):
        PartitionedCore(100, 3)           # not divisible
    core = PartitionedCore(128, 2, device="cpu")
    with pytest.raises(ValueError):
        core.add_allocation(0, 10, [63, 64])    # spans partitions
    with pytest.raises(ValueError):
        core.route([], "nearest")          # unknown routing
    assert core.route([], "best_acceptance") == []
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError):
            core.route([], "best_acceptance", legacy_raise=True)
    with pytest.raises(ValueError):
        FleetScheduler(n_chips=128, n_partitions=2, engine="host")
    with pytest.raises(ValueError, match="auto_release"):
        PartitionedCore(128, 2, backfill="easy", park_capacity=4,
                        device="cpu")
    with pytest.raises(ValueError, match="park_capacity"):
        PartitionedCore(128, 2, backfill="easy", auto_release=True,
                        device="cpu")
    with pytest.raises(ValueError, match="device engine"):
        FleetScheduler(n_chips=128, engine="host", index_tile=16)


def test_partitioned_records_merge_lanes():
    core = PartitionedCore(128, 2, device="cpu")
    core.add_allocation(0, 100, [0, 1])          # lane 0
    core.add_allocation(50, 150, [64, 65])       # lane 1
    recs = core.records()
    assert recs[0] == (0, frozenset({0, 1}))
    assert (50, frozenset({0, 1, 64, 65})) in recs
    assert recs[-1] == (150, frozenset())
    assert core.load == [200.0, 200.0]
    core.delete_allocation(0, 100, [0, 1])
    core.delete_allocation(50, 150, [64, 65])
    assert core.records() == [] and core.load == [0.0, 0.0]


def test_lane_update_grows_every_lane():
    core = PartitionedCore(64, 2, capacity=4, device="cpu")
    for k in range(6):
        core.add_allocation(10 * k, 10 * k + 5, [k])
    assert all(s.tl.capacity == 16 for s in core.states)
    assert len(core.records()) == 12
    ref = ref_fleet.PartitionedCore(64, 2, capacity=4)
    for k in range(6):
        ref.add_allocation(10 * k, 10 * k + 5, [k])
    assert core.records() == ref.records()
    assert core.dispatches == ref.dispatches


def test_find_allocation_struct_and_t_now():
    core = PartitionedCore(128, 2, device="cpu")
    ref = ref_fleet.PartitionedCore(128, 2)
    core.add_allocation(0, 500, list(range(40)))
    ref.add_allocation(0, 500, list(range(40)))
    req = ARRequest(t_a=0, t_r=0, t_du=100, t_dl=900, n_pe=40)
    from repro.core.types import ARRequest as RefRequest
    rreq = RefRequest(0, 0, 100, 900, 40)
    for pol in (Policy.FF, Policy.PE_W, Policy.DU_W):
        got = core.find_allocation(req, pol, t_now=50)
        want = ref.find_allocation(rreq, pol, t_now=50)
        assert (got.t_s, got.t_e, got.pe_ids) == \
            (want.t_s, want.t_e, want.pe_ids)
        again = core.find_allocation(None, pol, struct=core.stage_request(
            req))
        assert again.pe_ids == ref.find_allocation(rreq, pol).pe_ids
    wide = ARRequest(t_a=0, t_r=0, t_du=10, t_dl=20, n_pe=65)
    assert core.find_allocation(wide, Policy.FF) is None


# ---------------------------------------------------------------------------
# a scripted day against the reference, durations pinned
# ---------------------------------------------------------------------------


def _specs(n_jobs, seed, sizes=(8, 16, 32, 64)):
    rng = np.random.default_rng(seed)
    cells = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES
             if applicable(get_config(a), s)[0]]
    out = []
    for i in range(n_jobs):
        arch, shape = cells[int(rng.integers(len(cells)))]
        out.append(dict(arch=arch, shape=shape,
                        n_chips=int(rng.choice(sizes)),
                        n_steps=int(rng.integers(20, 300)),
                        deadline_slack=float(rng.choice([0.5, 1.0, 3.0]))))
    return out


def _day(f, n_jobs=24, seed=0):
    """Batches, clock steps, failures, stragglers, rescales and
    malleable jobs; each pick is a function of the fleet's own state."""
    specs = _specs(n_jobs, seed)
    live = (JobState.RESERVED, JobState.RUNNING)
    f.submit_batch(specs[:n_jobs // 2])
    f.advance(300)
    f.submit_batch(specs[n_jobs // 2:])
    for k in range(2):
        held = sorted(j.job_id for j in f.jobs.values()
                      if j.state in live and j.chips)
        if held:
            f.fail_chip(f.jobs[held[0]].chips[-1])
            f.report_straggler(held[-1], slowdown=1.4)
            f.rescale(held[len(held) // 2], 16)
        f.submit_malleable("stablelm-1.6b", "train_4k", [8, 16, 32],
                           n_steps=150 + 50 * k)
        f.advance(f.now + 2000)     # past the repair window
    f.advance(f.now + 10 ** 7)
    return ([(j.job_id, j.state.value, j.t_start, j.t_end, tuple(j.chips),
              j.preemptions, j.n_chips, j.partition)
             for j in sorted(f.jobs.values(), key=lambda j: j.job_id)],
            list(f.events))


@pytest.mark.parametrize("kw", [
    dict(engine="device"), dict(engine="host"),
    dict(engine="device", policy=Policy.FF, index_tile=16),
    dict(n_partitions=2), dict(n_partitions=4, routing="best_acceptance"),
    dict(n_partitions=2, routing="least_loaded")],
    ids=lambda kw: "-".join(f"{k}={getattr(v, 'value', v)}"
                            for k, v in kw.items()))
def test_scripted_day_equals_the_reference(kw, reference_durations):
    ref_kw = dict(kw)
    if ref_kw.get("engine") == "device":
        ref_kw["use_kernel"] = False
    ref = _day(RefFleet(n_chips=128, **ref_kw))
    port = _day(_fleet(n_chips=128, **kw))
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    kinds = {e[1] for e in port[1]}
    assert {"reserve", "complete", "chip-fail"} <= kinds


def test_partitioned_batches_match_the_routing_oracle(reference_durations):
    f = _fleet(n_chips=128, n_partitions=2, routing="best_acceptance")
    specs = _specs(30, 3)
    jobs = f.submit_batch(specs)
    reqs = []
    for sp in specs:
        dur = pt_fleet.estimate_duration(sp["arch"], sp["shape"],
                                         sp["n_chips"], sp["n_steps"])
        reqs.append(ARRequest(t_a=0, t_r=0, t_du=dur, n_pe=sp["n_chips"],
                              t_dl=int(dur * (1.0 + sp["deadline_slack"]))))
    oracle = FleetRoutingOracle(128, 2)
    want = oracle.admit_batch(reqs, Policy.PE_W, "best_acceptance")
    got = [None if j.state == JobState.REJECTED else
           (j.t_start, j.t_end, tuple(j.chips)) for j in jobs]
    assert got == [None if a is None else (a.t_s, a.t_e, a.pe_ids)
                   for a in want]
    assert any(g is None for g in got) and any(got)
    assert f.core.records() == oracle.records()
