"""The port's cost model (paddle_tpu_torch/cost_model.py) against the JAX
package's: the same layout and the same card figures (a ChipSpec from
the JAX tables) cost the same floats; the port's own card table; and the
measured side (flops, bytes, time, the per-op table) on the CPU."""
import importlib
import itertools

import pytest
import torch

from paddle_tpu import cost_model as jcm
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.planner.memory import HBM_BYTES as J_HBM

from paddle_tpu_torch import cost_model as cm
from paddle_tpu_torch.models.gpt import GPTConfig

# the modules (their packages export a function of the same name)
jmfu = importlib.import_module("paddle_tpu.telemetry.mfu")
mfu = importlib.import_module("paddle_tpu_torch.telemetry.mfu")

V5P = cm.ChipSpec("v5p", J_HBM["v5p"], jmfu.device_peak_flops("v5p"),
                  jcm.ICI_BW_BY_CHIP["v5p"], jcm.DCN_BW_BYTES)

LAYOUTS = [dict(dp=dp, pp=pp, mp=mp, sp=sp, ep=ep, zero_stage=z,
                micro_batch=mb)
           for dp, pp, mp, sp, ep, z, mb in itertools.product(
               (1, 4), (1, 2, 4), (1, 8), (1, 2), (1, 2), (1, 3), (1, 2))]


@pytest.mark.parametrize("dcn", (False, True))
def test_estimate_layout_cost_equals_jax(dcn):
    cal = {"psum": 1.7, "all_gather": 0.6, "ppermute": 2.5,
           "all_to_all": 3.1}
    for lo in LAYOUTS:
        for c in (None, cal):
            kw = dict(n_params=1_315_575_808, num_layers=24,
                      hidden_size=2048, seq_len=2048, ffn_hidden_size=8192,
                      vocab_size=50304, dp_over_dcn=dcn, comm_calibration=c,
                      **lo)
            want = jcm.estimate_layout_cost(chip="v5p", **kw)
            assert cm.estimate_layout_cost(chip=V5P, **kw) == want
    for lo in LAYOUTS[:8]:
        assert cm.layout_cost_from_config(GPTConfig.gpt3_13b(), chip=V5P,
                                          **lo) == \
            jcm.layout_cost_from_config(JGPTConfig.gpt3_13b(), chip="v5p",
                                        **lo)


def test_wire_bytes_and_flops_equal_jax():
    for nbytes, n in itertools.product((0, 1, 4096, 123457), (1, 2, 3, 8)):
        assert cm._allreduce_wire_bytes(nbytes, n) == \
            jcm._allreduce_wire_bytes(nbytes, n)
        assert cm._allgather_wire_bytes(nbytes, n) == \
            jcm._allgather_wire_bytes(nbytes, n)
    for args in ((124_000_000, 12, 768, 1024), (13e9, 40, 5120, 2048)):
        assert mfu.model_flops_per_token(*args) == \
            jmfu.model_flops_per_token(*args)


def test_the_ports_card_table():
    h = cm.resolve_chip("h100")
    assert (h.hbm_bytes, h.peak_flops, h.link_bw, h.dcn_bw) == \
        (85017493504, 989e12, 900e9, 50e9)
    assert cm.resolve_chip(V5P) is V5P
    assert cm.LINK_BW_BY_CHIP["gloo"] is None
    assert cm.device_peak_link_bw("NVIDIA H100 80GB HBM3") == 900e9
    assert cm.device_peak_link_bw("gloo") is None
    assert cm.device_peak_link_bw("cpu") is None
    with pytest.raises(ValueError, match="ChipSpec"):
        cm.estimate_layout_cost(n_params=1, num_layers=1, hidden_size=8,
                                seq_len=8, chip="gloo")
    out = cm.estimate_layout_cost(n_params=1_315_575_808, num_layers=24,
                                  hidden_size=2048, seq_len=2048, mp=4,
                                  num_micro=4)
    assert out["tp_s"] > 0 and out["dp_grad_s"] == 0.0


def test_measured_cost_on_the_cpu():
    a, b = torch.randn(64, 32), torch.randn(32, 16)

    def fn(x, y):
        return torch.relu(x @ y)
    got = cm.CostModel().profile_measure(fn, (a, b), warmup=1, repeat=3)
    assert got["flops"] == 2 * 64 * 32 * 16
    # the matmul's operands and result, the relu's operand and result
    assert got["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 3 * 64 * 16)
    assert got["time_s"] > 0 and got["arithmetic_intensity"] > 0
    assert cm.CostModel().static_cost(fn, (a, b)) == {
        "flops": got["flops"], "bytes_accessed": got["bytes_accessed"]}
    prof = cm.ProgramCostModel().instruction_profile(fn, (a, b))
    ops = {r["op"]: r["count"] for r in prof["by_op"]}
    assert ops.get("mm") == 1 and ops.get("relu") == 1
    assert prof["n_instructions"] == sum(ops.values())
