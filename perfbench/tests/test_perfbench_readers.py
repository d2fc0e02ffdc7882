"""The per-layer readers and the trace's reduction on made-up traces whose
answers are known."""
import pytest

import run
from harness import flops, spec as specs, trace

GRANITE = specs.load("granite-train-4k")
RESNET = specs.load("resnet50-naive-x7")


def _flash_ops(steps, fwd_us, dq_us, dkv_us, drop=0):
    ops = ([("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64>", 0.0, fwd_us)] * (80 * steps)
           + [("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64>", 0.0, dq_us)] * (40 * steps)
           + [("void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 64>", 0.0, dkv_us)] * (40 * steps))
    return ops[: len(ops) - drop]


@pytest.mark.parametrize("fwd_name,bwd_name", [("flash_fwd_roofline", "flash_bwd_roofline"),
                                                ("flash_fwd_4k_roofline", "flash_bwd_4k_roofline")])
def test_roofline_readers(fwd_name, bwd_name):
    steps = GRANITE["traffic_data"]["trace_steps"]
    fwd = flops.least_time(*flops.flash_call("fwd", 2, 32, 8, 4096, 64))
    ctx = {"spec": GRANITE, "trace": {"ops": _flash_ops(steps, fwd * 1e6 / 0.4, 500.0, 700.0)}}
    assert run.read_metric(fwd_name, ctx) == pytest.approx(40.0)
    dq = flops.least_time(*flops.flash_call("dq", 2, 32, 8, 4096, 64))
    dkv = flops.least_time(*flops.flash_call("dkv", 2, 32, 8, 4096, 64))
    assert run.read_metric(bwd_name, ctx) == pytest.approx(100 * (dq + dkv) / 1200e-6)
    ctx["trace"]["ops"] = _flash_ops(steps, 1.0, 1.0, 1.0, drop=1)  # a call missing: shapes unknown
    assert run.read_metric(bwd_name, ctx) is None
    assert run.read_metric(fwd_name, {"spec": GRANITE, "trace": {"ops": []}}) is None


@pytest.mark.parametrize("suffix,idle", [("", ".train"), (".finetune", ".finetune")])
def test_elementwise_idle_and_mfu_readers(suffix, idle):
    steps = GRANITE["traffic_data"]["trace_steps"]
    ops = [("nvjet_tst_192x192", 0.0, 900.0), ("void at::native::vectorized_elementwise_kernel<4>", 0.0, 300.0),
           ("Memcpy HtoD (Pageable -> Device)", 0.0, 50.0), ("void at::native::reduce_kernel<512>", 0.0, 100.0)]
    ctx = {"spec": GRANITE, "trace": {"ops": ops, "busy_s": 0.9, "window_s": 1.0}, "run": {"rate": 10_000.0}}
    assert run.read_metric("elementwise_ms_per_step" + suffix, ctx) == pytest.approx(0.4 / steps)
    assert run.read_metric("device_idle_share" + idle, ctx) == pytest.approx(10.0)
    assert run.read_metric("device_idle_share.resnet", ctx) is None
    per_step = flops.dense_train_flops(GRANITE["config_data"]["model"], 2, 4096)
    assert run.read_metric("mfu" + idle, ctx) == pytest.approx(100 * 10_000 / 8192 * per_step / 989e12)
    assert run.read_metric("mfu.resnet", ctx) is None


def test_resnet_readers():
    ctx = {"spec": RESNET, "trace": {"busy_s": 0.5, "window_s": 2.0},
           "run": {"rate": 1000.0, "step_ms": [float(i) for i in range(1, 101)]}}
    assert run.read_metric("device_idle_share.resnet", ctx) == pytest.approx(75.0)
    assert run.read_metric("step_ms_p95.resnet", ctx) == pytest.approx(95.05)
    fwd = flops.resnet_forward_flops(RESNET["config_data"]["model"])
    assert run.read_metric("mfu.resnet", ctx) == pytest.approx(100 * 1000 * 3 * fwd / 67e12)
    assert run.read_metric("mfu.train", ctx) is None


def test_combine_unions_jobs_and_names_gaps():
    a = {"window": (0.0, 100.0), "device": [("k1", 10.0, 20.0), ("k2", 25.0, 10.0)],
         "host": [("step", 0.0, 100.0), ("aten::item", 35.0, 30.0)]}
    b = {"window": (5.0, 90.0), "device": [("k3", 60.0, 10.0), ("k1", 85.0, 20.0)], "host": [("other", 5.0, 85.0)]}
    out = trace.combine([a, b])
    assert out["window_s"] == pytest.approx(85e-6)  # the span both annotations cover
    # busy: [10, 35] and [60, 70] and [85, 90] clipped = 25 + 10 + 5
    assert out["busy_s"] == pytest.approx(40e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    # gaps [5, 10) under "other" (latest start covering 5), [35, 60) under aten::item, [70, 85) under "other"
    assert gaps == pytest.approx({"other": 20e-6, "aten::item": 25e-6})
    assert dict(out["breakdown"]["device_ops"]) == pytest.approx({"k1": 25e-6, "k2": 10e-6, "k3": 10e-6})
