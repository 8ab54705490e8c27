"""The frozen arithmetic against hand counts."""
from _small import ROOT  # noqa: F401

from gpubench.arith import flops
from gpubench.arith.busy import busy_seconds, idle_gaps
from gpubench.arith.sampler_cost import stratified_sample_cost


def test_nature_cnn_forward_is_18_69_mflop_a_frame():
    macs = (20 * 20 * 8 * 8 * 4 * 32 + 9 * 9 * 4 * 4 * 32 * 64
            + 7 * 7 * 3 * 3 * 64 * 64 + 3136 * 512)
    assert macs == 9_342_976
    assert flops.nature_cnn_fwd_flops(1) == 18_685_952.0
    assert flops.nature_cnn_fwd_flops(512) == 512 * 18_685_952.0


def test_heads_and_grad_step():
    dueling = {"hidden": 512, "num_atoms": 1, "dueling": True}
    quantile = {"hidden": 512, "num_atoms": 200, "dueling": False}
    assert flops.head_outputs(dueling, 6) == 7
    assert flops.head_outputs(quantile, 6) == 1200
    one = flops.forward_flops(quantile, 6, 1)
    assert one == 2.0 * (9_342_976 + 512 * 1200)
    assert flops.grad_step_flops(quantile, 6, 256) == 5 * 256 * one


def test_population_draw_is_32_07_mb():
    cost = stratified_sample_cost(62_500, 16, 512, members=8)
    assert cost["bytes"] == 8 * (62_500 * 16 * 4 + 512 * 16 + 4)
    assert round(cost["bytes"] / 1e6, 2) == 32.07
    # 3.35 TB/s: 0.00957 ms.
    assert round(cost["bytes"] / 3.35e12 * 1e3, 5) == 0.00957


def test_busy_union_and_gaps():
    spans = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0), (35.0, 36.0)]
    assert busy_seconds(spans) == 30.0 / 1e6
    assert idle_gaps(spans) == [(20.0, 30.0)]
    assert busy_seconds([]) == 0.0
