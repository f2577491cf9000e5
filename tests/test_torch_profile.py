"""The trace summary of `vspbfr_tpu_torch.cli.profile`, on made-up events,
and its `--smart` summary on the CPU.

The profiler needs a CUDA device, so this checks only the arithmetic that
turns a trace into the numbers PERF.md quotes: kernel grouping, device time
per group, and the busy / idle share of the window (exact, in
microseconds); for `--smart`, the work K5's bound is computed from (exact
counts) and one row of the summary at a tiny shape, where K5 and the
composition both run their plain versions (equal values, no launches).
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from vspbfr_tpu_torch.cli.profile import (  # noqa: E402
    bound_ms,
    kernel_group,
    profile_smart,
    smart_grad_work,
    smart_work,
    summarize,
)


def _ev(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("name, group", [
    ("void dense_conv_kernel<float, 8>(float const*, ...)", "K1 dense_conv"),
    ("void vspbfr::(anonymous namespace)::dense_conv_kernel<float, false>"
     "(float const*, ...)", "K1 dense_conv"),
    ("void vspbfr::(anonymous namespace)::dense_conv_kernel<float, true>"
     "(float const*, ...)", "K1e dense_conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::dense_conv_kernel<__nv_bfloat16, "
     "true>(__nv_bfloat16 const*, ...)", "K1e dense_conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::dense_conv_kernel<__nv_bfloat16, "
     "true, vspbfr::tile::Mma<2, 4, 4>>(__nv_bfloat16 const*, ...)",
     "K1e dense_conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::dense_conv_kernel<float, false, "
     "vspbfr::tile::Fma<8, 2, 4>>(float const*, ...)", "K1 dense_conv"),
    ("void dilated_multi_kernel<__nv_bfloat16>(...)",
     "K2 dilated_multi_conv"),
    ("void vspbfr::(anonymous namespace)::dilated_multi_kernel<float, "
     "vspbfr::tile::Fma<4, 1, 4>>(float const*, ...)",
     "K2 dilated_multi_conv"),
    ("void vspbfr::(anonymous namespace)::dilated_multi_kernel<"
     "__nv_bfloat16, vspbfr::tile::Mma<2, 4, 1>>(__nv_bfloat16 const*, ...)",
     "K2 dilated_multi_conv"),
    ("void d2s_kernel<uint4>(uint4 const*, ...)", "K3 d2s"),
    ("void s2d_kernel<uint4>(uint4 const*, ...)", "K4 s2d"),
    ("void vspbfr::(anonymous namespace)::smart_fused_kernel<float, 8>"
     "(float const*, ...)", "K5 smart_core"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<__nv_bfloat16, 8>"
     "(__nv_bfloat16 const*, ...)", "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<float, 1>(...)",
     "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::fused_lrelu_kernel<float, 4>"
     "(float const*, ...)", "K7 fused_leaky_relu"),
    ("void vspbfr::(anonymous namespace)::interleave_stack_kernel<uint4>"
     "(uint4 const*, ...)", "K8 interleave"),
    ("void vspbfr::(anonymous namespace)::interleave_repeat_kernel<uint2>"
     "(uint2 const*, ...)", "K8 interleave"),
    ("void vspbfr::(anonymous namespace)::stripe_conv_kernel<__nv_bfloat16,"
     " 1>(__nv_bfloat16 const*, ...)", "K9/K10 stripe_conv"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32", "library conv"),
    ("cutlass_80_simt_sgemm_128x64_8x5_nn_align1", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduce"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void upfirdn_something_else", "other"),
])
def test_kernel_group(name, group):
    assert kernel_group(name) == group


def test_summarize_groups_and_idle_share():
    events = [
        _ev("aten::conv2d", 0.0, 5.0, DeviceType.CPU),
        _ev("aten::add", 50.0, 52.0, DeviceType.CPU),
        _ev("dense_conv_kernel", 10.0, 30.0),
        _ev("dense_conv_kernel", 25.0, 40.0),   # overlaps the first
        _ev("d2s_kernel", 60.0, 70.0),
        _ev("vectorized_elementwise_kernel", 90.0, 110.0),
    ]
    s = summarize(events)
    assert s["device_ms_by_group"] == pytest.approx(
        {"K1 dense_conv": 0.035, "elementwise": 0.020, "K3 d2s": 0.010})
    assert list(s["device_ms_by_group"]) == ["K1 dense_conv", "elementwise",
                                             "K3 d2s"]
    assert s["device_ms_total"] == pytest.approx(0.065)
    assert s["window_ms"] == pytest.approx(0.110)
    assert s["busy_ms"] == pytest.approx(0.060)   # 10-40, 60-70, 90-110
    assert s["idle_share"] == pytest.approx(1 - 60 / 110)
    assert s["n_kernels"] == 4
    assert s["top_kernels"][0] == {"name": "dense_conv_kernel", "ms":
                                   pytest.approx(0.035), "calls": 2}


def test_summarize_refuses_a_trace_without_device_kernels():
    with pytest.raises(RuntimeError, match="no device kernel"):
        summarize([_ev("aten::add", 0.0, 1.0, DeviceType.CPU)])


def test_smart_work_counts_the_taps_inside_the_image():
    # 4x4 image, C 4, Cb 1, Cout 4: taps inside per axis are 10 (dilation
    # 1), 8 (2), 4 (4) and 4 (8, only the centre tap)
    flops, moved = smart_work(1, 4, 4, 4, 1, 4, 4)
    mac = 4 * 1 * (10 * 10 + 8 * 8 + 4 * 4 + 4 * 4) + 4 * 4 * 100
    assert flops == 2 * mac + 64
    assert moved == 4 * (64 + 4 + 144 + 4 + 144 + 64)
    assert bound_ms(67e12, 0, "f32") == (pytest.approx(1e3), "operations")
    assert bound_ms(0, 3.35e12, "bf16") == (pytest.approx(1e3), "bytes")


def test_smart_grad_work_is_the_recompute_plus_dx_and_dw():
    flops, _ = smart_work(1, 4, 4, 4, 1, 4, 4)
    mac = 4 * 1 * (10 * 10 + 8 * 8 + 4 * 4 + 4 * 4) + 4 * 4 * 100
    gflops, gmoved = smart_grad_work(1, 4, 4, 4, 1, 4, 4)
    assert gflops == flops + 4 * mac
    assert gmoved == 4 * (2 * (64 + 4 + 144 + 144) + 64)


def test_profile_smart_summary_on_the_cpu():
    rows = profile_smart(torch.float32, device="cpu", shapes=((8, 8),),
                         batch=1, timer=lambda fn: (fn(), 2.0)[1])
    (r,) = rows
    assert (r["size"], r["channels"], r["batch"], r["dtype"]) == (8, 8, 1,
                                                                  "f32")
    assert r["max_rel_diff"] <= 1e-6
    assert r["k5_ms"] == r["composition_ms"] == 2.0
    assert r["composition_over_k5"] == 1.0
    assert r["k5_launches"] == 0 and r["composition_launches"] == {
        "dilated_multi_conv": 0, "dense_conv": 0}
    assert (r["flops"], r["bytes"]) == smart_work(1, 8, 8, 8, 2, 8, 4)
    assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
