"""The port's configs and roofline cost model against the JAX package's.

The configurations are copies, so every field must be equal.  The cost
model's counts (FLOPs, bytes, parameters) depend only on the
configuration and the mesh and must be equal for every arch x shape x
mesh the fleet builds; only ``Costs.terms`` reads the card's constants,
which are the H100's in the port.  The compiled-HLO collective parse
(``_shape_bytes``, ``parse_collectives``) equals the reference's on the
reference test's text and on texts with tuples, every collective kind
and the ``-start`` forms.
"""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro.roofline import analysis as ref_roof
from repro.runtime import fleet as ref_fleet
from repro_torch import configs
from repro_torch.roofline import analysis as roof
from repro_torch.runtime import fleet

COUNT_FIELDS = ("flops", "hbm_bytes", "coll_intra_bytes", "coll_inter_bytes",
                "n_params", "n_active_params", "model_flops")
# card counts the fleet prices jobs at: footprints, malleable variants
# and rescales from 1 card to the whole 512-card fleet
CHIP_COUNTS = (1, 2, 8, 16, 32, 64, 96, 128, 256, 384, 512)


def _fleet_mesh(n_chips):
    """The mesh ``estimate_duration`` builds for ``n_chips`` cards."""
    model = min(16, n_chips)
    return {"data": max(n_chips // model, 1), "model": model}


def test_configs_are_the_reference_configs():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        assert dataclasses.asdict(configs.get_config(arch)) == \
            dataclasses.asdict(ref_configs.get_config(arch))
    assert [dataclasses.asdict(s) for s in configs.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in ref_configs.ALL_SHAPES]
    for arch in configs.ARCH_IDS:
        for shape in configs.ALL_SHAPES:
            assert configs.applicable(configs.get_config(arch), shape) == \
                ref_configs.applicable(ref_configs.get_config(arch),
                                       ref_configs.shape_by_name(shape.name))
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
    with pytest.raises(KeyError):
        configs.shape_by_name("train_1m")
    small = configs.get_config("qwen3-4b").reduced()
    assert dataclasses.asdict(small) == dataclasses.asdict(
        ref_configs.get_config("qwen3-4b").reduced())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_step_cost_counts_equal_the_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert roof.param_count(cfg) == ref_roof.param_count(ref_cfg)
    meshes = [_fleet_mesh(n) for n in CHIP_COUNTS] + [
        {"pod": 2, "data": 16, "model": 16}]     # the inter-pod term
    for shape in configs.ALL_SHAPES:
        ref_shape = ref_configs.shape_by_name(shape.name)
        for mesh in meshes:
            got = roof.step_costs(cfg, shape, mesh)
            want = ref_roof.step_costs(ref_cfg, ref_shape, mesh)
            for f in COUNT_FIELDS:
                assert getattr(got, f) == getattr(want, f), (shape.name,
                                                             mesh, f)


def test_terms_use_the_h100_constants_only():
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.NVLINK_BW,
            roof.BYTES_PER_PARAM) == (989.4e12, 3.35e12, 450e9, 2)
    assert not hasattr(roof, "ICI_BW")
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape in configs.ALL_SHAPES:
            for mesh in (_fleet_mesh(64), {"pod": 2, "data": 8,
                                           "model": 16}):
                c = roof.step_costs(cfg, shape, mesh)
                chips = 1
                for v in mesh.values():
                    chips *= v
                t = c.terms(chips)
                assert t["compute_s"] == c.flops / (chips * 989.4e12)
                assert t["memory_s"] == c.hbm_bytes / (chips * 3.35e12)
                assert t["collective_s"] == (
                    c.coll_intra_bytes / (chips * 450e9)
                    + c.coll_inter_bytes / (chips * 450e9 / 4))
                assert t["dominant"] == max(
                    ("compute", t["compute_s"]), ("memory", t["memory_s"]),
                    ("collective", t["collective_s"]),
                    key=lambda kv: kv[1])[0]
                assert t["useful_ratio"] == c.model_flops / c.flops
    assert roof.Costs().terms(4)["useful_ratio"] == 0.0


def test_estimate_duration_prices_jobs_on_the_h100():
    for arch in configs.ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for n in (16, 64, 256):
                terms = roof.step_costs(
                    configs.get_config(arch), configs.shape_by_name(shape),
                    _fleet_mesh(n)).terms(n)
                step = max(terms["compute_s"], terms["memory_s"],
                           terms["collective_s"]) / 0.5
                assert fleet.estimate_duration(arch, shape, n, 300) == \
                    max(int(step * 300) + 1, 60)
    # the curve of the reference: fewer cards, longer runs (at 10,000
    # steps: 100 steps fit the 60 s floor on 64 H100s)
    d256 = fleet.estimate_duration("qwen3-4b", "train_4k", 256, 10_000)
    d64 = fleet.estimate_duration("qwen3-4b", "train_4k", 64, 10_000)
    assert d64 > d256 * 2
    assert ref_fleet.estimate_duration(
        "qwen3-4b", "train_4k", 64, 10_000) > d64   # a v5e is slower


# HLO texts for the collective parse: the reference test's, tuples,
# every collective kind, ``-start`` forms, and lines that name a
# collective without being one
HLO_TEXTS = {
    "reference_test": """
  %ag = bf16[16,128]{1,0} all-gather(bf16[1,128]{1,0} %x), dims={0}
  %ar.1 = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%add
  %rs = (f32[8]{0}) reduce-scatter(f32[64]{0} %z), dimensions={0}
    """,
    "every_kind": """
  %a2a = bf16[4,32,64]{2,1,0} all-to-all(bf16[4,32,64]{2,1,0} %e), dimensions={0}
  %cp = s32[7]{0} collective-permute(s32[7]{0} %p), source_target_pairs={{0,1}}
  %ar = pred[3,3]{1,0} all-reduce(pred[3,3]{1,0} %m), to_apply=%or
  %ag2 = u8[1024]{0} all-gather(u8[64]{0} %b), dims={0}
  %rs2 = f16[2,2]{1,0} reduce-scatter(f16[32,2]{1,0} %h), dimensions={0}
  ROOT %ar64 = f64[5]{0} all-reduce(f64[5]{0} %d), to_apply=%add
    """,
    "tuples_and_start": """
  %ars = (bf16[128,256]{1,0}, f32[16]{0}) all-reduce-start(bf16[128,256]{1,0} %g, f32[16]{0} %s), to_apply=%add
  %ard = (bf16[128,256]{1,0}, f32[16]{0}) all-reduce-done(%ars)
  %ags = (bf16[8,64]{1,0}, bf16[64,64]{1,0}) all-gather-start(bf16[8,64]{1,0} %w), dims={0}
  %cps = (s8[2,16]{1,0}, s8[2,16]{1,0}, u32[], u32[]) collective-permute-start(s8[2,16]{1,0} %q)
  all-to-all(s64[3]{0} %bare)
    """,
    "no_collectives": """
  %add = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)
  %fusion = bf16[2,4]{1,0} fusion(%x), kind=kLoop, calls=%all-reduce-like
    """,
    "scalars_and_empty_dims": """
  %r = f32[] all-reduce(f32[] %l), to_apply=%add
  %g = bf16[0,16]{1,0} all-gather(bf16[0,1]{1,0} %z), dims={1}
    """,
}


@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_parse_collectives_equals_the_reference(name):
    text = HLO_TEXTS[name]
    got = roof.parse_collectives(text)
    assert got == ref_roof.parse_collectives(text)
    for line in text.splitlines():
        assert roof._shape_bytes(line) == ref_roof._shape_bytes(line)
    if name == "reference_test":
        assert got["all-gather"] == 16 * 128 * 2
        assert got["all-reduce"] == 256 * 4
    if name == "tuples_and_start":
        assert got["all-reduce"] == 128 * 256 * 2 + 16 * 4
        assert "all-reduce-done" not in got
    if name == "no_collectives":
        assert got == {"total": 0}
