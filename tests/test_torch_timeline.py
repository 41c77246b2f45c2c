"""The port's timeline updates against the JAX package, bit for bit.

Same numpy-seeded add/delete sequences through ``repro.core.timeline``
and ``repro_torch.core.timeline``; times, occupancy words, the overflow
flag and the needed record count must be equal (exact: every quantity
is an integer or a boolean).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import timeline as ref_tl
from repro.core.types import T_INF
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_timeline(rng, n_pe, capacity, n_jobs):
    tl = ref_tl.empty(capacity, n_pe)
    t = 0
    for _ in range(n_jobs):
        t_s = t + int(rng.integers(0, 10))
        t_e = t_s + int(rng.integers(1, 30))
        ids = rng.choice(n_pe, size=int(rng.integers(1, n_pe // 2 + 1)),
                         replace=False)
        bits = np.zeros(tl.words * 32, np.uint32)
        bits[ids] = 1
        mask = ref_tl.pack_bits(bits[None, :])[0]
        tl, overflow = ref_tl.update(tl, t_s, t_e, mask, is_add=True)
        assert not bool(overflow)
        t = t_s
    return tl


def to_port(tl):
    return pt_tl.Timeline(
        times=torch.from_numpy(np.asarray(tl.times).copy()),
        occ=torch.from_numpy(pt_words.to_int32(np.asarray(tl.occ))))


def assert_tl_equal(port, ref, ctx=""):
    np.testing.assert_array_equal(port.times.numpy(), np.asarray(ref.times),
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(pt_words.to_uint32(port.occ.numpy()),
                                  np.asarray(ref.occ), err_msg=str(ctx))


def _rand_mask_np(rng, n_pe, words):
    ids = rng.choice(n_pe, size=int(rng.integers(1, n_pe + 1)),
                     replace=False)
    bits = np.zeros(words * 32, np.uint32)
    bits[ids] = 1
    return np.asarray(ref_tl.pack_bits(bits[None, :])[0])


def _step(pair, t_s, t_e, mask_u32, is_add, ctx, lexsort=False):
    port, ref = pair
    fn_ref = ref_tl.update_lexsort if lexsort else ref_tl.update
    fn_port = pt_tl.update_lexsort if lexsort else pt_tl.update
    r, r_ovf, r_keep = fn_ref(ref, t_s, t_e, jnp.asarray(mask_u32),
                              is_add=is_add, with_count=True)
    p, p_ovf, p_keep = fn_port(
        port, t_s, t_e, torch.from_numpy(pt_words.to_int32(mask_u32)),
        is_add=is_add, with_count=True)
    assert bool(p_ovf) == bool(r_ovf), ctx
    assert int(p_keep) == int(r_keep), ctx
    assert_tl_equal(p, r, ctx)
    return (p, r), bool(p_ovf)


@pytest.mark.parametrize("seed", range(6))
def test_update_matches_reference_fuzzed(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.choice([4, 8, 16, 32]))
    n_pe = int(rng.choice([8, 33, 64]))
    pair = (pt_tl.empty(S, n_pe, CPU), ref_tl.empty(S, n_pe))
    words = pair[1].words
    for step in range(40):
        t_s = int(rng.integers(0, 120))
        t_e = t_s + int(rng.integers(0, 40))      # includes empty windows
        if rng.random() < 0.1:
            t_e = T_INF                            # the T_INF clamp
        if rng.random() < 0.05:
            t_s, t_e = t_e, t_s                    # inverted window
        pair, ovf = _step(pair, t_s, t_e, _rand_mask_np(rng, n_pe, words),
                          bool(rng.integers(0, 2)), (seed, step))
        if ovf:
            break


@pytest.mark.parametrize("seed", range(3))
def test_update_lexsort_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n_pe = 40
    pair = (pt_tl.empty(32, n_pe, CPU), ref_tl.empty(32, n_pe))
    for step in range(25):
        t_s = int(rng.integers(0, 100))
        t_e = t_s + int(rng.integers(1, 30))
        pair, ovf = _step(pair, t_s, t_e,
                          _rand_mask_np(rng, n_pe, pair[1].words),
                          bool(rng.integers(0, 2)), (seed, step),
                          lexsort=True)
        assert not ovf


def test_update_overflow_flag_and_count_match():
    n_pe = 4
    pair = (pt_tl.empty(4, n_pe, CPU), ref_tl.empty(4, n_pe))
    m = np.asarray(ref_tl.ids_to_mask32([0], 1))
    for i in range(2):             # 2 disjoint intervals -> 4 records
        pair, ovf = _step(pair, 100 * i, 100 * i + 10, m, True, i)
        assert not ovf
    # a third disjoint interval needs 6 records on capacity 4
    _, ovf = _step(pair, 500, 510, m, True, "overflow")
    assert ovf


@pytest.mark.parametrize("seed", range(4))
def test_update_many_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    n_pe, S, K = 33, 32, 8
    ref = _random_timeline(rng, n_pe, S, n_jobs=5)
    port = to_port(ref)
    is_add = bool(seed % 2 == 0)
    t_s = rng.integers(0, 80, K).astype(np.int32)
    t_e = (t_s + rng.integers(0, 25, K)).astype(np.int32)
    t_e[0] = T_INF                                  # deactivated by clamp
    masks = np.stack([_rand_mask_np(rng, n_pe, ref.words)
                      for _ in range(K)])
    active = rng.random(K) < 0.8
    r, r_ovf, r_keep = ref_tl.update_many(
        ref, jnp.asarray(t_s), jnp.asarray(t_e), jnp.asarray(masks),
        jnp.asarray(active), is_add=is_add, with_count=True)
    p, p_ovf, p_keep = pt_tl.update_many(
        port, torch.from_numpy(t_s), torch.from_numpy(t_e),
        torch.from_numpy(pt_words.to_int32(masks)),
        torch.from_numpy(active), is_add=is_add, with_count=True)
    assert (bool(p_ovf), int(p_keep)) == (bool(r_ovf), int(r_keep))
    assert_tl_equal(p, r)


@pytest.mark.parametrize("n_pe,capacity", [(8, 32), (100, 64), (200, 32)])
def test_queries_match_reference(n_pe, capacity):
    rng = np.random.default_rng(n_pe + capacity)
    ref = _random_timeline(rng, n_pe, capacity, n_jobs=10)
    port = to_port(ref)
    np.testing.assert_array_equal(pt_tl.next_times(port).numpy(),
                                  np.asarray(ref_tl.next_times(ref)))
    for t in (-5, 0, 3, 17, 60, 10_000, T_INF - 1):
        np.testing.assert_array_equal(
            pt_words.to_uint32(pt_tl.occupancy_at(port, t).numpy()),
            np.asarray(ref_tl.occupancy_at(ref, jnp.int32(t))))
    for a, b in ((0, 5), (3, 40), (20, 21), (50, 10_000), (7, 7)):
        np.testing.assert_array_equal(
            pt_words.to_uint32(pt_tl.window_busy(port, a, b).numpy()),
            np.asarray(ref_tl.window_busy(ref, jnp.int32(a), jnp.int32(b))))
    assert int(port.n_valid()) == int(ref.n_valid())


def test_growth_and_state_layout_match_reference():
    rng = np.random.default_rng(7)
    ref = _random_timeline(rng, 40, 16, n_jobs=4)
    assert_tl_equal(pt_tl.grow(to_port(ref), 64), ref_tl.grow(ref, 64))
    rs = ref_tl.init_state(16, 40, pending_capacity=8)
    ps = pt_tl.init_state(16, 40, pending_capacity=8, device=CPU)
    got = pt_tl.state_to_numpy(pt_tl.grow_state(ps, 32, 24))
    want = ref_tl.grow_state(rs, 32, 24)
    for name in ("pend_ts", "pend_te", "pend_mask"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(want, name)))
    np.testing.assert_array_equal(got["times"], np.asarray(want.tl.times))
    np.testing.assert_array_equal(got["occ"], np.asarray(want.tl.occ))
    assert got["occ"].dtype == np.uint32


def test_ids_to_mask32_and_from_host_match_reference():
    ids = [0, 1, 31, 32, 63, 70, 99]
    np.testing.assert_array_equal(
        pt_words.to_uint32(pt_tl.ids_to_mask32(ids, 4, n_pe=100).numpy()),
        np.asarray(ref_tl.ids_to_mask32(ids, 4, n_pe=100)))
    with pytest.raises(ValueError):
        pt_tl.ids_to_mask32([100], 4, n_pe=100)
    with pytest.raises(ValueError):
        pt_tl.ids_to_mask32([3, 3], 4, n_pe=100)
    times = np.array([0, 10, 25], np.int64)
    occ64 = np.array([[1 | (1 << 40), 7], [1 << 63, 0], [0, 0]], np.uint64)
    got = pt_tl.from_host(times, occ64, 100, 8, device=CPU)
    assert_tl_equal(got, ref_tl.from_host(times, occ64, 100, 8))
