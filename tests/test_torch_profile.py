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

from vspbfr_tpu_torch.cli import profile  # noqa: E402
from vspbfr_tpu_torch.cli.profile import (  # noqa: E402
    K6_CASES,
    bound_ms,
    device_ms,
    k6_operands,
    k6_work,
    kernel_group,
    profile_smart,
    smart_grad_work,
    smart_work,
    summarize,
)
from vspbfr_tpu_torch.ops.smart import PLAN_FIELDS, smart_plan  # noqa: E402


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
    ("void vspbfr::(anonymous namespace)::smart_fused_kernel<__nv_bfloat16,"
     " 2>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, vspbfr::("
     "anonymous namespace)::Plan, vspbfr::(anonymous namespace)::Vec)",
     "K5 smart_core"),
    ("void vspbfr::(anonymous namespace)::smart_fused_kernel<float, 0>"
     "(float const*, ...)", "K5 smart_core"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<__nv_bfloat16, 8>"
     "(__nv_bfloat16 const*, ...)", "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<float, 1>(...)",
     "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::fused_lrelu_kernel<float, 4>"
     "(float const*, ...)", "K7 fused_leaky_relu"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<__nv_bfloat16, "
     "float, 8, false>(vspbfr::StreamArgs<__nv_bfloat16, float>)",
     "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::epilogue_kernel<float, float, 4, "
     "true>(vspbfr::StreamArgs<float, float>)", "K6 conv_epilogue"),
    ("void vspbfr::(anonymous namespace)::fused_lrelu_kernel<__nv_bfloat16,"
     " __nv_bfloat16, 1, true>(vspbfr::StreamArgs<__nv_bfloat16, "
     "__nv_bfloat16>)", "K7 fused_leaky_relu"),
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
    calls = []

    def dev_timer(fns):
        calls.append(len(fns))
        fns[0]()
        return 3.0

    rows = profile_smart(torch.float32, device="cpu", shapes=((8, 8),),
                         batch=1, timer=lambda fn: (fn(), 2.0)[1],
                         dev_timer=dev_timer)
    (r,) = rows
    assert (r["size"], r["channels"], r["batch"], r["dtype"]) == (8, 8, 1,
                                                                  "f32")
    assert r["max_rel_diff"] <= 1e-6
    assert r["k5_ms"] == r["composition_ms"] == 2.0
    assert r["k5_device_ms"] == r["composition_device_ms"] == 3.0
    assert r["turns"]["k5_device_ms"] == [3.0, 3.0]
    assert r["k5_over_composition"] == 1.0
    # composition, K5, K5, composition, one operand set each on the CPU
    assert calls == [1, 1, 1, 1] and r["designs"] == {}
    assert r["k5_launches"] == 0 and r["composition_launches"] == {
        "dilated_multi_conv": 0, "dense_conv": 0}
    assert (r["flops"], r["bytes"]) == smart_work(1, 8, 8, 8, 2, 8, 4)
    assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"


def test_profile_smart_reports_the_plan_and_both_designs():
    """`--smart` reports K5's launch plan (`smart_plan` at the card's 132
    multiprocessors), and with `--designs` both clusters' device times in
    turns (a, b, b, a)."""
    order = []

    def dev_timer(fns):
        order.append(fns[0])
        return 1.0 + len(order)

    (r,) = profile_smart(torch.bfloat16, device="cpu", shapes=((8, 8),),
                         batch=1, timer=lambda fn: 2.0, dev_timer=dev_timer,
                         designs=profile.SMART_DESIGNS)
    plan = smart_plan(True, 1, 8, 8, 8, 2, 8)
    assert r["plan"] == plan
    assert all(k in plan for k in PLAN_FIELDS)
    assert (plan["TH"], plan["TW"], plan["cluster"]) == (16, 16, 8)
    assert r["plan_label"] == profile.plan_label(plan)
    (la, ca), (lb, cb) = profile.SMART_DESIGNS
    assert (ca, cb) == (1, 4)
    # after the composition and K5 in turns (2.0 .. 5.0): a, b, b, a
    assert r["designs"] == {la: {"cluster": 1, "device_ms": [6.0, 9.0]},
                            lb: {"cluster": 4, "device_ms": [7.0, 8.0]}}


class _FakeCuda:
    """The CUDA calls `device_ms` makes, on a made-up clock: each fn() call
    takes 2 ms of device time; the hold (`_sleep`) runs at 1e6 cycles a
    ms. `early` lists, for each timed run, whether the device had already
    reached the start event when the host finished enqueueing."""

    def __init__(self, early):
        self.early = list(early)
        self.sleeps = []
        self.calls = 0

    def sleep(self, cycles):
        self.sleeps.append(cycles)

    def event(self, enable_timing=False):
        fake = self

        class Event:
            def record(self):
                self.at = fake.calls

            def query(self):
                return fake.early.pop(0)

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return 2.0 * (end.at - self.at)

        return Event()


def test_device_ms_times_n_calls_behind_a_hold(monkeypatch):
    fake = _FakeCuda(early=[True, False, False, False])
    monkeypatch.setattr(torch.cuda, "Event", fake.event)
    monkeypatch.setattr(torch.cuda, "_sleep", fake.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profile, "_SLEEP_RATE", [1e9])

    def fn():
        fake.calls += 1

    assert device_ms(fn, n=5, warmup=2, repeats=3) == pytest.approx(2.0)
    # warm-up, the host's enqueue timing, then four timed runs of 5 calls
    assert fake.calls == 2 + 5 + 4 * 5
    # the first run's hold was too short (start already reached): the
    # second one holds twice as long, and the later ones keep it
    assert len(fake.sleeps) == 4
    assert fake.sleeps[1] == pytest.approx(2 * fake.sleeps[0], rel=1e-6)
    assert fake.sleeps[2] == fake.sleeps[3] == fake.sleeps[1]


def test_device_ms_refuses_a_function_that_never_lets_the_hold_cover_it(
        monkeypatch):
    fake = _FakeCuda(early=[True] * 64)
    monkeypatch.setattr(torch.cuda, "Event", fake.event)
    monkeypatch.setattr(torch.cuda, "_sleep", fake.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profile, "_SLEEP_RATE", [1e9])
    with pytest.raises(RuntimeError, match="synchronise"):
        device_ms(lambda: None, n=2, warmup=0)


def test_device_ms_rotates_copies_and_keeps_each_result_to_the_end(
        monkeypatch):
    fake = _FakeCuda(early=[False] * 2)
    monkeypatch.setattr(torch.cuda, "Event", fake.event)
    monkeypatch.setattr(torch.cuda, "_sleep", fake.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profile, "_SLEEP_RATE", [1e9])
    order, live, at_end = [], [0], []

    class Out:
        def __init__(self):
            live[0] += 1

        def __del__(self):
            live[0] -= 1

    def call(k):
        def fn():
            order.append(k)
            fake.calls += 1
            return Out()
        return fn

    real_event = fake.event

    def event(enable_timing=False):
        ev = real_event(enable_timing)
        sync = ev.synchronize
        ev.synchronize = lambda: (at_end.append(live[0]), sync())
        return ev

    monkeypatch.setattr(torch.cuda, "Event", event)
    assert device_ms([call(0), call(1), call(2)], n=5, warmup=1,
                     repeats=2) == pytest.approx(2.0)
    # warm-up, enqueue timing, two timed runs: the copies in turn
    assert order == [0] + [0, 1, 2, 0, 1] * 3
    # every result of a timed run is alive when its end event is waited for
    assert at_end == [5, 5] and live[0] == 0


@pytest.mark.parametrize("moved_mb,want", [(400, 1), (100, 1), (67, 3),
                                           (25, 5), (0.004, 20)])
def test_l2_copies_rotate_past_the_l2(monkeypatch, moved_mb, want):
    """Enough copies that the calls between two uses of one move twice the
    L2 (50 MB here), one where a call alone does, at most n."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(L2_cache_size=50 * 2**20))
    assert profile.l2_copies(int(moved_mb * 2**20), n=20) == want


@pytest.mark.parametrize("shape,pieces,label", K6_CASES)
def test_k6_work_counts_each_piece_and_tensor_once(shape, pieces, label):
    small = (2, 3, 4, shape[3])
    gen = torch.Generator().manual_seed(0)

    def rand(*s, scale=1.0, offset=0.0):
        return torch.randn(s, generator=gen) * scale + offset

    x, kw = k6_operands(rand, torch.bfloat16, small, pieces, torch.float32)
    n, c = x.numel(), small[3]
    flops, moved = k6_work(x, kw)
    per = (("s" in pieces) + ("n" in pieces) + ("b" in pieces)
           + 2 * ("a" in pieces) + pieces.count("p") + 4 * ("2" in pieces))
    assert flops == per * n
    small_ops = 4 * (("s" in pieces) * 2 * c + ("n" in pieces) * 24
                     + ("b" in pieces) * c + ("2" in pieces) * (24 + c))
    assert moved == 2 * n * (2 + pieces.count("p")) + small_ops
    assert k6_work(x, kw, mask=True)[1] == moved + n
    assert all(p.dtype == torch.bfloat16 for p in kw.get("post_add", ()))
