"""The port's meshes and lane placement against the JAX package's.

The one-device halves of ``tests/test_mesh_sharding.py``: the mesh
helpers, ``resolve_placement``, ``ServiceConfig.placement``'s defaults
and validation, and sessions under every placement deciding as each
other and as the reference's session of the same placement, with the
same ``metrics()["placement_shards"]``.  ``PartitionedCore`` and
``simulate_grid`` take placements too.  The lane-to-card block map
(lane ``i`` on card ``i // (E / d)``) is checked as a pure function of
a mesh of cards that need not be present.
"""
import numpy as np
import pytest
import torch

import jax

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.api import config as ref_config_mod
from repro.core.types import ALL_POLICIES as REF_POLICIES
from repro.core.types import ARRequest as RefRequest
from repro.launch import mesh as ref_mesh
from repro.runtime import fleet as ref_fleet
from repro.sim.sweep import GridSpec as RefGridSpec
from repro.sim.sweep import simulate_grid as ref_simulate_grid
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.api import config as config_mod
from repro_torch.core import ensemble as ens_lib
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import PartitionedCore
from repro_torch.sharding import rules
from repro_torch.sim import GridSpec, simulate_grid

PLACEMENTS = [None, "single", "host", "auto", 1]
N_PE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n=40, n_pe=N_PE):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(0, 25, n))
    jobs = []
    for i in range(n):
        du = int(rng.integers(5, 60))
        tr = int(t[i] + rng.integers(0, 30))
        jobs.append(ARRequest(t_a=int(t[i]), t_r=tr, t_du=du,
                              t_dl=tr + du + int(rng.integers(0, 120)),
                              n_pe=int(rng.integers(1, n_pe + 1))))
    return jobs


def _ref(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe) for j in jobs]


# ---------------------------------------------------------------------------
# the mesh seam: helpers + config validation
# ---------------------------------------------------------------------------

def test_mesh_helpers():
    host = mesh_lib.make_host_mesh("cpu")
    assert mesh_lib.data_shards(host) == 1
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)
    assert mesh_lib.local_device_count("cpu") == 1
    for lanes in (1, 6, 7, 63, 504):
        mesh = mesh_lib.make_lane_mesh(lanes, device="cpu")
        d = mesh_lib.data_shards(mesh)
        assert d == 1 and lanes % d == 0
        ref = ref_mesh.make_lane_mesh(lanes)
        assert ref_mesh.data_shards(ref) == d == len(jax.devices())
    capped = mesh_lib.make_lane_mesh(504, max_shards=2, device="cpu")
    assert mesh_lib.data_shards(capped) == 1
    with pytest.raises(ValueError):
        mesh_lib.make_lane_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        mesh_lib.Mesh(("data",), (2,), (torch.device("cpu"),))


def test_resolve_placement():
    assert mesh_lib.resolve_placement(None, 8, "cpu") is None
    assert mesh_lib.resolve_placement("single", 8, "cpu") is None
    for placement in ("host", "auto", 1, 4):
        mesh = mesh_lib.resolve_placement(placement, 8, "cpu")
        ref = ref_mesh.resolve_placement(placement, 8)
        assert mesh_lib.data_shards(mesh) == ref_mesh.data_shards(ref) == 1
        assert mesh.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        mesh_lib.resolve_placement("cluster", 8, "cpu")


def test_production_mesh_needs_its_cards():
    # the reference raises the same way with fewer than 256 devices
    with pytest.raises(ValueError):
        ref_mesh.make_production_mesh()
    with pytest.raises(ValueError):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError):
        mesh_lib.make_production_mesh(multi_pod=True)


def test_placement_config_validation():
    assert ServiceConfig(n_pe=8).placement == RefConfig(n_pe=8).placement \
        == "auto"
    assert config_mod.PLACEMENTS == ref_config_mod.PLACEMENTS
    for good in ("auto", "single", "host", None, 4, 1):
        ServiceConfig(n_pe=8, placement=good)
        RefConfig(n_pe=8, placement=good)
    ServiceConfig(n_pe=8, placement=None, donate=False)
    for bad in ("cluster", 0, -2, True, 1.5):
        with pytest.raises((ValueError, TypeError)):
            ServiceConfig(n_pe=8, placement=bad)
        with pytest.raises((ValueError, TypeError)):
            RefConfig(n_pe=8, placement=bad)


def test_lane_to_card_block_map():
    cards = tuple(torch.device("cuda", i) for i in range(4))
    lane4 = mesh_lib.Mesh(("data",), (4,), cards)
    assert rules.lane_devices(lane4, 8) == tuple(
        cards[i // 2] for i in range(8))
    assert rules.lane_devices(lane4, 4) == cards
    # on a (data, model) mesh a data shard's lanes go to its first card
    grid = mesh_lib.Mesh(("data", "model"), (2, 2), cards)
    assert rules.lane_devices(grid, 6) == (cards[0],) * 3 + (cards[2],) * 3
    with pytest.raises(ValueError):
        rules.lane_devices(lane4, 6)
    assert rules.lane_devices(None, 3, "cpu") == (torch.device("cpu"),) * 3
    host = mesh_lib.make_host_mesh("cpu")
    assert rules.lane_devices(host, 5) == (torch.device("cpu"),) * 5


def test_shard_ensemble_is_the_identity_on_one_device():
    states = ens_lib.init_ensemble(3, 16, 8, 16, device="cpu")
    assert rules.shard_ensemble(None, states) is states
    assert rules.shard_ensemble(mesh_lib.make_host_mesh("cpu"),
                                states) is states
    # a one-card mesh elsewhere moves every lane there
    moved = rules.shard_ensemble(
        mesh_lib.Mesh(("data",), (1,), (torch.device("meta"),)), states)
    assert all(s.tl.times.device.type == "meta" for s in moved)


# ---------------------------------------------------------------------------
# placement never changes a decision
# ---------------------------------------------------------------------------

def test_ensemble_sessions_under_every_placement():
    lanes = 4
    streams = [_stream(11 + e) for e in range(lanes)]
    policies = [ALL_POLICIES[e % len(ALL_POLICIES)] for e in range(lanes)]
    kw = dict(n_pe=N_PE, lanes=lanes, capacity=4, pending_capacity=4,
              chunk_size=16, ring_capacity=64)
    base = None
    for placement in PLACEMENTS:
        port = ReservationService(ServiceConfig(
            placement=placement, device="cpu", **kw)).session()
        res = port.offer(streams, policy=policies)
        got = tuple(np.asarray(x) for x in (
            res.decision.accepted, res.decision.t_s, res.decision.pe_mask,
            res.valid))
        m = port.metrics()
        assert m["growths"] >= 1 and m["placement_shards"] == 1
        recs = [port.records(e) for e in range(lanes)]
        ref = RefService(RefConfig(placement=placement, **kw)).session()
        rres = ref.offer([_ref(s) for s in streams],
                         policy=[REF_POLICIES[e % len(REF_POLICIES)]
                                 for e in range(lanes)])
        for a, b in zip(got, (rres.decision.accepted, rres.decision.t_s,
                              rres.decision.pe_mask, rres.valid)):
            np.testing.assert_array_equal(a, np.asarray(b))
        rm = ref.metrics()
        for k in ("offered", "accepted", "growths", "placement_shards"):
            assert m[k] == rm[k], (placement, k)
        assert recs == [ref._backend.records(e) for e in range(lanes)]
        if base is None:
            base = (got, m, recs)
            continue
        for a, b in zip(got, base[0]):
            np.testing.assert_array_equal(a, b)
        for k in ("offered", "accepted", "growths", "chunks",
                  "placement_shards"):
            assert m[k] == base[1][k], (placement, k)
        assert recs == base[2]


@pytest.mark.parametrize("placement", ["single", "auto"])
def test_reference_placement_shards_match(placement):
    kw = dict(n_pe=N_PE, lanes=2, capacity=32, chunk_size=8,
              ring_capacity=32, placement=placement)
    port = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    ref = RefService(RefConfig(**kw)).session()
    assert port.metrics()["placement_shards"] == \
        ref.metrics()["placement_shards"] == 1


def test_partitioned_core_under_every_placement():
    jobs = _stream(5, n=60, n_pe=8)
    base = None
    for placement in PLACEMENTS:
        core = PartitionedCore(32, 4, capacity=8, placement=placement,
                               device="cpu")
        assert core.mesh is None if placement in (None, "single") \
            else mesh_lib.data_shards(core.mesh) == 1
        allocs = core.admit_stream_allocations(jobs, Policy.FF,
                                               routing="least_loaded")
        got = ([None if a is None else (a.t_s, a.t_e, a.pe_ids)
                for a in allocs], core.records(), core.load)
        ref = ref_fleet.PartitionedCore(32, 4, capacity=8,
                                        placement=placement)
        rallocs = ref.admit_stream_allocations(
            _ref(jobs), REF_POLICIES[list(ALL_POLICIES).index(Policy.FF)],
            routing="least_loaded")
        assert got[0] == [None if a is None else
                          (a.t_s, a.t_e, tuple(a.pe_ids)) for a in rallocs]
        assert got[1] == ref.records() and got[2] == ref.load
        if base is None:
            base = got
        assert got == base, placement
    # partition sessions carry the placement to their core
    sess = ReservationService(ServiceConfig(
        n_pe=32, n_partitions=4, chunk_size=None, placement="host",
        device="cpu")).session()
    assert mesh_lib.data_shards(sess.engine.mesh) == 1


def test_simulate_grid_placement_equals_single():
    kw = dict(n_jobs=40, n_pe=16, seeds=(0,), arrival_factors=(1.0,),
              flex_factors=(0.5,), policies=(Policy.FF, Policy.DU_B),
              backfill_modes=("none", "easy"))
    single = simulate_grid(GridSpec(**kw), capacity=32, placement=None,
                           record_decisions=True, device="cpu")
    auto = simulate_grid(GridSpec(**kw), capacity=32, placement="auto",
                         record_decisions=True, device="cpu")
    np.testing.assert_array_equal(single.acceptance, auto.acceptance)
    assert single.decisions == auto.decisions
    ref = ref_simulate_grid(RefGridSpec(**dict(
        kw, policies=tuple(REF_POLICIES[list(ALL_POLICIES).index(p)]
                           for p in kw["policies"]))),
        capacity=32, placement="auto", record_decisions=True)
    np.testing.assert_array_equal(auto.n_accepted, ref.n_accepted)
