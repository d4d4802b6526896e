"""`repro_torch.launch.roofline` against `repro.launch.roofline`: the
useful-work formulas equal the reference's exactly on every arch and
shape, and `analyze_cell` gives the reference's record (its formulas for
the terms, the dominant term, the bound, the roofline fraction and the
useful-flop ratio) from the same counts once the reference's constants
are set to the H100's, with its two keys renamed (`xla_cost_analysis_raw`
-> `flop_counter_raw`, `n_whiles` -> `n_loops`) and the collectives'
split by fabric beside the reference's fields.
"""
import types

import pytest

from repro.configs import base as rbase
from repro.launch import roofline as RR
from repro_torch.configs import base as tbase
from repro_torch.dist.op_analysis import OpCost
from repro_torch.launch import roofline as TR

# one dot of [8, 16] x [16, 32]: 8,192 flops, 3,584 bytes
HLO = """HloModule m

ENTRY %main (a: f32[8,16], b: f32[16,32]) -> f32[8,32] {
  %a = f32[8,16]{1,0} parameter(0)
  %b = f32[16,32]{1,0} parameter(1)
  ROOT %d = f32[8,32]{1,0} dot(f32[8,16]{1,0} %a, f32[16,32]{1,0} %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""
MEMORY = {"argument_size_in_bytes": 3 << 30, "output_size_in_bytes": 1 << 30,
          "temp_size_in_bytes": 5 << 20, "alias_size_in_bytes": 1 << 29,
          "generated_code_size_in_bytes": 0}
RENAMED = {"xla_cost_analysis_raw": "flop_counter_raw",
           "n_whiles": "n_loops"}


class FakeCompiled:
    """What the reference's `analyze_cell` reads of a compiled step."""

    def cost_analysis(self):
        return {"flops": 8192.0, "bytes accessed": 3584.0}

    def as_text(self):
        return HLO

    def memory_analysis(self):
        return types.SimpleNamespace(**MEMORY)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_active_param_count_equals_reference(arch):
    assert TR.active_param_count(tbase.get_config(arch)) == \
        RR.active_param_count(rbase.get_config(arch))


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_model_flops_equals_reference(arch, shape):
    assert TR.model_flops(tbase.get_config(arch), tbase.SHAPES[shape]) == \
        RR.model_flops(rbase.get_config(arch), rbase.SHAPES[shape])


def test_constants_are_the_h100s():
    assert (TR.PEAK_BF16, TR.PEAK_INT8, TR.HBM_BW, TR.LINK_BW, TR.IB_BW) \
        == (989e12, 1.979e15, 3.35e12, 450e9, 50e9)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch,shape", [("qwen3_14b", "decode_32k"),
                                        ("stablelm_3b", "train_4k"),
                                        ("phi35_moe", "prefill_32k"),
                                        ("xlstm_1_3b", "long_500k")])
def test_analyze_cell_equals_reference_record(monkeypatch, arch, shape,
                                              int8):
    for name, value in (("PEAK_BF16", TR.PEAK_BF16),
                        ("PEAK_INT8", TR.PEAK_INT8), ("HBM_BW", TR.HBM_BW),
                        ("ICI_LINK_BW", TR.LINK_BW)):
        monkeypatch.setattr(RR, name, value)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1})
    ref = RR.analyze_cell(FakeCompiled(), rbase.get_config(arch),
                          rbase.SHAPES[shape], mesh, "single", int8=int8)
    cost = OpCost(flops=8192.0, hbm_bytes=3584.0, n_loops=0)
    got = TR.analyze_cell(cost, MEMORY, tbase.get_config(arch),
                          tbase.SHAPES[shape], 1, "single", int8=int8,
                          flop_counter_raw=8192.0)
    assert set(got) == {RENAMED.get(k, k) for k in ref}
    for k, v in ref.items():
        if k == "xla_cost_analysis_raw":
            assert got["flop_counter_raw"] == {"flops": v["flops"]}
        elif k == "collectives":      # and the split by fabric, all 0
            fabric = got[k].pop("bytes_by_fabric")
            assert fabric == {"nvlink": 0.0, "infiniband": 0.0}
            assert got[k] == v
        else:
            assert got[RENAMED.get(k, k)] == v, k


def test_analyze_cell_dominant_term_and_bound():
    cfg, shape = tbase.get_config("qwen3_14b"), tbase.SHAPES["decode_32k"]
    cost = OpCost(flops=TR.PEAK_BF16 * 2e-3, hbm_bytes=TR.HBM_BW * 5e-3,
                  collective_bytes=TR.LINK_BW * 1e-3,
                  collective_bytes_by_fabric={"nvlink": TR.LINK_BW * 1e-3})
    rec = TR.analyze_cell(cost, {}, cfg, shape, 1, "single")
    assert rec["dominant"] == "memory_s"
    assert rec["step_time_lower_bound_s"] == pytest.approx(5e-3)
    assert rec["terms"]["compute_s"] == pytest.approx(2e-3)
    assert rec["terms"]["collective_s"] == pytest.approx(1e-3)
    assert rec["hbm_bytes_per_dev"] == 0
    rec8 = TR.analyze_cell(cost, {}, cfg, shape, 1, "single", int8=True)
    assert rec8["terms"]["compute_s"] == pytest.approx(
        2e-3 * TR.PEAK_BF16 / TR.PEAK_INT8)
