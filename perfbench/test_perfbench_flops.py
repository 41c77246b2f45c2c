"""The frozen FLOP and byte counts against hand-worked values, and the
metric readers on synthetic runs."""
import pytest

from perfbench import harness
from perfbench.yardstick import flops
from perfbench.yardstick.spec import Spec

STABLELM = Spec(name="stablelm-1.6b", family="dense", n_layers=24,
                d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
                vocab=100352)
GRANITE = Spec(name="granite-moe-1b-a400m", family="moe", n_layers=24,
               d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
               n_experts=32, top_k=8, tie_embeddings=True)


def test_stablelm_counts():
    # a layer: 4 x 2048^2 attention + 3 x 2048 x 5632 MLP = 51,380,224
    assert flops.param_count(STABLELM) == (1_644_167_168, 1_644_167_168)
    assert flops.touched_weights(STABLELM) == 1_438_646_272
    # 6 x 1,438,646,272 + 6 x 24 x 4096 x 2048
    assert flops.model_flops_per_token(STABLELM, 4096) == 9_839_837_184
    work, nbytes = flops.attention_call(STABLELM, 2, 4096)
    assert work == 274_877_906_944 + 137_438_953_472
    assert nbytes == 67_108_864 + 33_554_432


def test_granite_counts():
    # a layer: 3,145,728 attention + 32,768 router + 32 x 1,572,864 experts,
    # and one 49,155 x 1,024 matrix, the embedding and the head tied
    assert flops.param_count(GRANITE) == (1_334_578_176, 428_608_512)
    # active: 24 x (3,145,728 + 32,768 + 8 x 1,572,864) + the head
    assert flops.touched_weights(GRANITE) == 428_608_512
    assert flops.model_flops_per_token(GRANITE, 512) == 2_647_148_544
    work, nbytes = flops.attention_call(GRANITE, 64, 512)
    assert work == 137_438_953_472 + 68_719_476_736 + 34_359_738_368
    assert nbytes == 134_217_728 + 6_291_456


@pytest.mark.parametrize("spec", (STABLELM, GRANITE), ids=("dense", "moe"))
def test_a_tied_head_is_still_multiplied(spec):
    import dataclasses
    untied = dataclasses.replace(spec, tie_embeddings=False)
    tied = dataclasses.replace(spec, tie_embeddings=True)
    emb = spec.vocab * spec.d_model
    assert flops.param_count(untied)[0] == flops.param_count(tied)[0] + emb
    assert flops.touched_weights(tied) == flops.touched_weights(untied)


def test_forward_flops_counts_the_head():
    head = 2 * 2048 * 100352
    layer = (2 * 2048 * 64 * 96 + 2 * 32 * 64 * 2048 + 4 * 32 * 64 * 4096
             + 6 * 2048 * 5632)
    assert flops.forward_flops(STABLELM, 1, 4096) == 24 * layer + head


def test_least_time_takes_the_slower_bound():
    assert flops.least_time_s(989.4e12, 1.0) == pytest.approx(1.0)
    assert flops.least_time_s(1.0, 3.35e12) == pytest.approx(1.0)


def _run(**over):
    run = {"steps": 2, "tokens_per_step": 8192, "spec": STABLELM,
           "mix": {"batch": 2, "microbatches": 1, "seq_len": 4096},
           "routing": {"kept": 60, "slots": 80},
           "device": {"memory_peak_bytes": 3 * 2 ** 30},
           "trace": {"window_s": 4.0, "busy_s": 3.0, "device_ops": 20_000,
                     "spans": {"perfbench.self_attention":
                               {"device_s": 1.0, "calls": 96},
                               "perfbench.moe": {"device_s": 0.5, "calls": 96},
                               "perfbench.update": {"device_s": 0.2,
                                                    "calls": 2}}}}
    run.update(over)
    return run


READS = {"attention_fwd_ms": 500.0, "moe_fwd_ms": 250.0, "optim_ms": 100.0,
         "kernels_per_step": 10_000.0, "idle_share": 25.0,
         "peak_mem_gib": 3.0, "moe_slot_use": 75.0,
         "attention_roofline": 100.0 * 96 * 412_316_860_416 / 989.4e12,
         "mfu": 100.0 * 9_839_837_184 * 16384 / 4.0 / 989.4e12}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_on_a_synthetic_run(name):
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "metric")
    assert reader.read(_run()) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "metric")
    empty = _run(routing=None, device={},
                 trace={"window_s": 0.0, "busy_s": 0.0, "device_ops": 0,
                        "spans": {}})
    assert reader.read(empty) is None
