"""The early reject's one-window rectangle against the JAX package.

The plain versions of the one-window entries
(``kernels.ref.availscan_one_ref`` / ``availscan_one_mr_ref``) and the
routed ``kernels.ops.window_rectangle`` at ``P = 1``, held against the
reference's rectangles (the Pallas kernels in interpret mode through
``repro.kernels.ops.availability_rectangles``, and the jnp path) on
random timelines of ``repro_torch.kernels.cases`` and on hand-made edge
cases, for R = 1 and R = 4; the entries' argument checks without a card;
and the rejected search result as views of the one output row.  Exact
equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import search as ref_search
from repro.core import timeline as ref_tl
from repro.core.resources import ResourceSpec as RefSpec
from repro.kernels import ops as ref_ops
from repro_torch.core import search as pt_search
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.resources import ResourceSpec, device_layout
from repro_torch.core.types import T_INF
from repro_torch.kernels import availscan as K
from repro_torch.kernels import cases
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import ref as pt_ref

CPU = torch.device("cpu")
LAYOUTS = {"R1-64": (64,), "R1-40": (40,), "R4-64": (64, 8, 4, 16),
           "R4-40": (40, 6, 3, 40)}


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _row(spec, times, occ, s, t_du, t_now):
    """The port's plain one-window row, and the same through ops."""
    tt = torch.from_numpy(times)
    oo = torch.from_numpy(pt_words.to_int32(occ))
    if spec.R == 1:
        row = pt_ref.availscan_one_ref(tt, oo, s, t_du, t_now, spec.n_pe)
        view = pt_ops.window_rectangle(pt_tl.Timeline(tt, oo), s, t_du,
                                       t_now, spec.n_pe)
    else:
        lay = device_layout(spec, CPU)
        row = pt_ref.availscan_one_mr_ref(tt, oo, s, lay.valid_mask,
                                          lay.plane_of_word, spec.R, t_du,
                                          t_now)
        view = pt_ops.window_rectangle(pt_tl.Timeline(tt, oo), s, t_du,
                                       t_now, spec.n_pe, rspec=spec)
    return row, view


def assert_window_matches_reference(units, times, occ, s, t_du, t_now):
    """Row and views against the Pallas kernel and the jnp rectangles at
    the one start ``s``; ``t_s``, ``t_e``, ``found`` and the PE mask are
    the rejected search result's."""
    spec = ResourceSpec(units)
    rs = RefSpec(units) if spec.R > 1 else None
    tl = ref_tl.Timeline(times=jnp.asarray(times), occ=jnp.asarray(occ))
    starts = jnp.asarray([s], jnp.int32)
    args = (tl, starts, jnp.int32(t_du), jnp.int32(t_now), units[0])
    pallas = ref_ops.availability_rectangles(*args, rspec=rs)
    plain = ref_search.availability_rectangles(*args, rspec=rs)
    row, view = _row(spec, times, occ, s, t_du, t_now)
    W = occ.shape[1]
    assert row.dtype == torch.int32 and row.shape == (spec.R + 5 + W,)
    for want in (pallas, plain):
        tail = (np.asarray(want.n_free_tail)[0] if rs is not None
                else np.zeros(0, np.int32))
        expect = np.concatenate([
            [int(want.n_free[0]), int(want.t_begin[0]), int(want.t_end[0])],
            tail, [s, _wrap(s + t_du), 0], np.zeros(W, np.int64)])
        np.testing.assert_array_equal(row.numpy(), expect,
                                      err_msg=f"{units} s={s} t_du={t_du}")
    for i, f in enumerate(("n_free", "t_begin", "t_end")):
        assert int(view[f]) == int(row[i]), f
    assert (int(view["t_s"]), int(view["t_e"])) == (s, _wrap(s + t_du))
    assert view["found"].dtype == torch.bool and not bool(view["found"])
    assert view["pe_mask"].shape == (W,) and not view["pe_mask"].any()
    np.testing.assert_array_equal(view["n_free_tail"].numpy(),
                                  row[3:spec.R + 2].numpy())
    return row


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_one_window_matches_pallas(name):
    """Random timelines of ``cases.random_timeline`` and starts over
    their span (before it, on boundaries, between them, past them)."""
    units = LAYOUTS[name]
    spec = ResourceSpec(units)
    rng = np.random.default_rng(sum(units))
    for fill in (0.2, 0.9):
        times, occ = cases.random_timeline(rng, spec, None, 64, fill)
        live = times[times < T_INF]
        span = int(live[-1])
        picks = [int(x) for x in rng.choice(live, size=3)]
        picks += [int(x) for x in rng.integers(-20, span + 50, 4)]
        for s in picks:
            t_du = int(rng.integers(1, 300))
            t_now = int(rng.integers(-10, span))
            assert_window_matches_reference(units, times, occ, s, t_du,
                                            t_now)


def _edge_timeline(units):
    """Six records at 10, 20, ..., 60 (then T_INF padding, capacity 16):
    A over [10, 20), [30, 40) and [50, 60) plus B over [50, 60), nothing
    in between.  A holds units 0-9 of plane 0 and unit 0 of every other
    plane; B units 10-14 of plane 0 and unit 1 of the last plane."""
    spec = ResourceSpec(units)
    bits = np.zeros((2, spec.total_bits), np.uint8)
    bits[0, :10] = 1
    bits[1, 10:15] = 1
    for r in range(1, spec.R):
        bits[0, spec.bit_offset(r)] = 1
    if spec.R > 1:
        bits[1, spec.bit_offset(spec.R - 1) + 1] = 1
    a, b = (np.packbits(x, bitorder="little").view("<u4") for x in bits)
    times = np.full(16, T_INF, np.int32)
    times[:6] = [10, 20, 30, 40, 50, 60]
    occ = np.zeros((16, spec.total_words), np.uint32)
    occ[0] = occ[2] = a
    occ[4] = a | b
    return times, occ


# (label, s, t_du, t_now, what the reference must report)
EDGES = [
    ("start before times[0]", 2, 5, 0, lambda r: r[2] == 10),
    ("start before times[0], overlapping record 0", 5, 10, 0,
     lambda r: r[2] == 50),
    ("window past the last record", 70, 5, 0, lambda r: r[1] == 60),
    ("start at the T_INF - t_du clamp", T_INF - 100, 100, 0,
     lambda r: r[1] == 60 and r[2] == T_INF),
    ("start above the clamp", T_INF - 1, 100, 0,
     lambda r: r[1] == 60 and r[2] == T_INF),
    ("t_now above the latest blocking end", 45, 3, 44,
     lambda r: r[1] == 44),
    ("t_now above the start", 45, 3, 100, lambda r: r[1] == 45),
    ("nothing blocks on either side", 30, 30, 7,
     lambda r: r[1] == 7 and r[2] == T_INF),
]


@pytest.mark.parametrize("label,s,t_du,t_now,pin", EDGES,
                         ids=[e[0] for e in EDGES])
@pytest.mark.parametrize("name", ["R1-40", "R4-40"])
def test_one_window_edge_cases_match_pallas(name, label, s, t_du, t_now,
                                            pin):
    units = LAYOUTS[name]
    times, occ = _edge_timeline(units)
    row = assert_window_matches_reference(units, times, occ, s, t_du, t_now)
    assert pin(row.tolist()), (label, row.tolist()[:3])


def test_dead_start_reports_zeros():
    """A start at T_INF is dead: zeros in the rectangle, as the P = 1
    rectangle of the plain many-candidate version reports."""
    for units in (LAYOUTS["R1-40"], LAYOUTS["R4-40"]):
        spec = ResourceSpec(units)
        times, occ = _edge_timeline(units)
        row, view = _row(spec, times, occ, T_INF, 5, 0)
        assert row[:spec.R + 2].tolist() == [0] * (spec.R + 2)
        assert (int(view["t_s"]), int(view["t_e"])) == (T_INF, _wrap(
            T_INF + 5))


@pytest.mark.parametrize("R", [1, 4])
def test_one_window_entries_raise_without_a_card(R):
    """The CUDA entries take CUDA tensors and int32 scalars only, and
    check the scalars first; ``ops.window_rectangle`` sends a tensor off
    the CPU to them, never to the plain version."""
    units = LAYOUTS["R1-40" if R == 1 else "R4-40"]
    spec = ResourceSpec(units)
    tl = pt_tl.empty(16, 40, "cpu", words=spec.total_words)
    lay = device_layout(spec, CPU)
    if R == 1:
        def call(s=3, t_du=4, t_now=0, n_pe=40, tl=tl):
            return K.availscan_one(tl.times, tl.occ, s, t_du, t_now, n_pe)
    else:
        def call(s=3, t_du=4, t_now=0, n_pe=40, tl=tl):
            return K.availscan_one_mr(tl.times, tl.occ, s, lay.valid_mask,
                                      lay.plane_of_word, R, t_du, t_now,
                                      n_pe=n_pe)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    for bad, match in ((dict(s=2**31), "int32"), (dict(s=-2**31 - 1), "int32"),
                       (dict(t_du=0), "int32"), (dict(t_du=T_INF), "int32"),
                       (dict(t_now=2**31), "int32"), (dict(n_pe=0), "n_pe"),
                       (dict(n_pe=4096), "n_pe")):
        with pytest.raises(ValueError, match=match):
            call(**bad)
    meta = pt_tl.Timeline(tl.times.to("meta"), tl.occ.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_ops.window_rectangle(meta, 3, 4, 0, 40,
                                rspec=spec if R > 1 else None)
    assert set(K.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("R", [1, 4])
def test_rejected_result_is_views_of_one_row(R):
    """The early reject's ``SearchResult``: every field a view of one
    int32 row (on the card, one launch and nothing else), with the
    reference's rejected values."""
    units = LAYOUTS["R1-40" if R == 1 else "R4-40"]
    spec = ResourceSpec(units)
    times, occ = _edge_timeline(units)
    tl = pt_tl.Timeline(torch.from_numpy(times),
                        torch.from_numpy(pt_words.to_int32(occ)))
    rspec = spec if R > 1 else None
    valid = device_layout(spec, CPU).valid_mask if R > 1 else None
    res = pt_search._rejected(tl, 12, 8, 40, 5, 40, rspec, valid)
    ptrs = {x.untyped_storage().data_ptr() for x in res}
    assert len(ptrs) == 1
    assert res.found.dtype == torch.bool and res.found.shape == ()
    assert not bool(res.found) and not res.pe_mask.any()
    assert res.pe_mask.shape == (spec.total_words,)
    assert (int(res.t_s), int(res.t_e)) == (12, 20)
    rects = pt_search.availability_rectangles(
        tl, torch.tensor([12], dtype=torch.int32), 8, 5, 40, rspec=rspec,
        valid_mask=valid)
    assert (int(res.n_free), int(res.t_begin), int(res.t_end)) == (
        int(rects.n_free[0]), int(rects.t_begin[0]), int(rects.t_end[0]))
