"""The trace reduction of ``benchmarks/profile_stages.py`` on synthetic
input: stage names from scope paths, the HLO-text map, the attribution
order, and the busy-time union."""

import pytest

from benchmarks.profile_stages import (attribute, busy_ns, hlo_stage_map,
                                       stage_of_text)

HLO = """HloModule jit__fit_chunk, entry_computation_layout={()}

%fused_exp.2 (param_0: f32[4]) -> f32[4] {
  %param_0 = f32[4]{0} parameter(0)
  ROOT %exponential.3 = f32[4]{0} exponential(%param_0), metadata={op_name="jit(_fit_chunk)/vmap(otf_zoom)/exp" source_file="x.py"}
}

ENTRY %main.9 (Arg_0.1: f32[4]) -> f32[4] {
  %Arg_0.1 = f32[4]{0} parameter(0)
  %loop_exponential_fusion.2 = f32[4]{0} fusion(%Arg_0.1), kind=kLoop, calls=%fused_exp.2
  %custom-call.1 = f32[4]{0} custom-call(%loop_exponential_fusion.2), custom_call_target="__cublas$gemm", metadata={op_name="jit(_fit_chunk)/moffat_fit/dot_general"}
  ROOT %add.4 = f32[4]{0} add(%custom-call.1, %Arg_0.1)
}
"""


@pytest.mark.parametrize("text,stage", [
    ("jit(_fit_chunk)/vmap(psd)/mul", "psd"),
    ("jit(_fit_chunk)/otf_zoom/jit(_psf_cube_from_base_jit)/exp", "otf_zoom"),
    ("jit(f)/convolve/fft", "convolve"),
    ("jit(f)/moffat_fit/while/body/dot", "moffat_fit"),
    ("jit(f)/dphi_extra/mul", None),       # whole tokens only
    ("", None),
])
def test_stage_of_text(text, stage):
    assert stage_of_text(text) == stage


def test_hlo_stage_map_own_metadata_and_called_computation():
    m = hlo_stage_map(HLO)
    assert m["custom_call_1"] == "moffat_fit"          # own op_name
    assert m["loop_exponential_fusion_2"] == "otf_zoom"  # via calls=
    assert "add_4" not in m                             # no metadata


def test_attribute_by_hlo_op_kernel_name_and_neighbour():
    m = hlo_stage_map(HLO)
    events = [
        (0, 5, "loop_exponential_fusion_2", {"hlo_op": "command_buffer"}),
        (6, 7, "sm80_xmma_gemm_f32", {"hlo_op": "custom-call.1"}),
        (20, 3, "sm80_other_gemm", {}),                 # neighbour: fit
        (30, 2, "k", {"tf_op": "jit(f)/convolve/fft"}),  # scope in stats
    ]
    per, by_neighbour, top = attribute(events, m)
    assert per["otf_zoom"] == 5 and per["moffat_fit"] == 10
    assert per["convolve"] == 2 and by_neighbour == 3 and top == []
    per, by_neighbour, top = attribute([(0, 4, "unknown", {})], m)
    assert sum(per.values()) == 0 and top == [("unknown", 4)]


def test_busy_ns_is_the_union_of_intervals():
    ev = [(0, 10, "a", {}), (5, 10, "b", {}), (30, 5, "c", {}),
          (31, 1, "d", {})]
    assert busy_ns(ev) == 15 + 5
    assert busy_ns([]) == 0
