"""The port's LM workloads of the collocation characterization on the CPU, at
reduced size: the CLI over every family at train_4k (gradient accumulation to
the suite's batch), the accumulated, prefill and decode steps' counts against
the reference's lowered programs, the hand-written kernels' entries in the op
counters (their FLOP formulas at the shapes ``PERF.md`` reckons, on meta
tensors: nothing is allocated), and the skip of a workload whose train state
exceeds the card.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import ShapeSuite as JSuite
from repro.configs.registry import get_config as jget_config
from repro.core import metrics as jmetrics
from repro.core.collocation import paper_experiment_grid as jgrid
from repro.core.instance import InstanceRecord as JInstanceRecord
from repro.launch import lowering as jlowering
from repro.telemetry import hlo as jhlo
from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.core import partitioner
from repro_torch.core.instance import JobSpec, measure_job
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.launch import collocate, lowering
from repro_torch.models.model_api import build_model
from repro_torch.telemetry import counts
from repro_torch.telemetry.counts import OpLog, count_step
from repro_torch.telemetry.hlo import HBM_OPS, hlo_flops_bytes

FAMILIES = ("granite-3-2b", "llava-next-34b", "olmoe-1b-7b", "zamba2-7b", "whisper-base", "rwkv6-1.6b")
CPU = torch.device("cpu")
#: an H100 80GB's ``total_memory``, the full profile's budget on the card
H100_BYTES = 85_017_362_432
#: as ``test_torch_dryrun.py``: the port's FLOPs over the reference's
#: ``hlo_flops_bytes`` of its program, (port / reference - 1)
TOL_FLOPS = 0.02


@pytest.fixture(scope="module")
def lm_artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("collocation_lm")
    rc = collocate.main(["--workloads", ",".join(FAMILIES), "--device", "cpu", "--reduced", "--out", str(out)])
    assert rc == 0
    return out


def _cells(out):
    return {f.name: json.loads(f.read_text()) for f in sorted(out.glob("*.json")) if not f.name.startswith("_")}


def test_every_family_is_characterized_under_the_reference_names(lm_artifacts):
    """Every grid cell of each family (the reference's grid on the h100-80gb
    tree) and its shared-mode cells, under the reference's label rule."""
    want = {"_summary.json"}
    for w in FAMILIES:
        for _, group, _ in jgrid([w], JSuite("train_4k", 4096, 256, "train"), sku="h100-80gb"):
            want.add(f"{w}__{group.replace(' ', '_').replace('.', '_')}.json")
        want |= {f"{w}__{m}_x{k}.json" for m in ("naive", "mps") for k in (2, 4, 7)}
    assert {f.name for f in lm_artifacts.iterdir()} == want
    summary = json.loads((lm_artifacts / "_summary.json").read_text())
    assert summary == {"cells": len(want) - 1, "failures": 0}
    assert all(c["status"] == "OK" and c["measured"] for c in _cells(lm_artifacts).values())


def test_lm_cells_take_the_train_4k_suite(lm_artifacts):
    for name, c in _cells(lm_artifacts).items():
        assert c["suite"] == "train_4k" and c["samples_per_epoch"] == 1_281_167, name
        assert all(r["shape"] == "train_4k" for r in c["records"]), name


def test_epoch_time_is_the_references(lm_artifacts):
    """``epoch_time_s`` of every record, against the reference's
    ``repro.core.metrics.epoch_time_s`` on the same record at the reduced
    suite's global batch."""
    for name, c in _cells(lm_artifacts).items():
        want = [jmetrics.epoch_time_s(JInstanceRecord(**r), c["samples_per_epoch"], collocate.REDUCED_BATCH)
                for r in c["records"]]
        assert c["epoch_time_s"] == pytest.approx(want, rel=1e-12), name


def test_workload_suite_accumulates_to_the_suites_batch():
    cfg, suite, samples, g = collocate.workload_suite("granite-3-2b")
    assert suite == collocate.LM_SUITE and samples == 1_281_167
    assert g == 128 and suite.global_batch == g * collocate.LM_MICRO_BATCH
    cfg, suite, samples, g = collocate.workload_suite("granite-3-2b", reduced=True)
    assert suite == ShapeSuite("train_4k", collocate.REDUCED_LM_SEQ, collocate.REDUCED_BATCH, "train") and g == 2
    assert collocate.workload_suite("resnet_small")[3] == 1


# ---------------------------------------------------------------------------
# the accumulated, prefill and decode steps against the reference's programs
# ---------------------------------------------------------------------------


def _reference_flops(monkeypatch, suite: JSuite, grad_accum: int = 1) -> float:
    """The reference's ``lower_cell`` of reduced granite on a one-device mesh,
    its compiled program counted by ``hlo_flops_bytes``."""
    jcfg = jget_config("granite-3-2b").reduced()
    monkeypatch.setattr(jlowering, "get_config", lambda arch: jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, _, lowered = jlowering.lower_cell("granite-3-2b", suite, mesh, grad_accum=grad_accum)
    return jhlo.hlo_flops_bytes(lowered.compile().as_text())["flops"]


def test_accumulated_step_flops_match_the_reference_program(monkeypatch):
    """``measure_job`` at grad_accum 2 counts one whole step, both micro
    batches and the update, as the reference's program of the same step."""
    want = _reference_flops(monkeypatch, JSuite("train_4k", 32, 4, "train"), grad_accum=2)
    job = JobSpec("granite#0", "granite-3-2b", ShapeSuite("train_4k", 32, 4, "train"), grad_accum=2)
    m = measure_job(job, get_config("granite-3-2b").reduced(), CPU)
    assert abs(m.flops / want - 1) <= TOL_FLOPS, (m.flops, want)
    # two micro batches: about twice one (the update's elementwise work has no product)
    one = measure_job(JobSpec("granite#0", "granite-3-2b", ShapeSuite("train_4k", 32, 2, "train")),
                      get_config("granite-3-2b").reduced(), CPU)
    assert m.flops == pytest.approx(2 * one.flops, rel=1e-9)
    assert m.kernels == {}  # off the card the plain versions run, counted as aten ops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_step_flops_match_the_reference_program(kind, monkeypatch):
    """The prefill (the whole batch at the suite's length) and the decode step
    (at the last slot of a cache of the suite's length), counted by
    ``measure_job``, against the reference's ``lower_cell`` of the same suite."""
    want = _reference_flops(monkeypatch, JSuite(f"{kind}_t", 32, 4, kind))
    job = JobSpec("granite#0", "granite-3-2b", ShapeSuite(f"{kind}_t", 32, 4, kind))
    m = measure_job(job, get_config("granite-3-2b").reduced(), CPU)
    assert abs(m.flops / want - 1) <= TOL_FLOPS, (m.flops, want)
    assert m.step_s > 0 and m.measured == ("step_s", "hlo_fingerprint")


def test_decode_cell_fills_the_cache_of_the_suites_length():
    cfg = get_config("granite-3-2b").reduced()
    suite = ShapeSuite("decode_t", 32, 4, "decode")
    model, state, batch, step = lowering.build_cell(cfg, suite, CPU)
    want = {k: shape for k, (shape, _) in model.cache_spec(4, 32).items()}
    assert {k: tuple(v.shape) for k, v in state["cache"].items()} == want
    # the prefill of 31 tokens filled every slot but the last, which the step writes
    assert bool(state["cache"]["k"][:, :, :31].abs().sum(dim=(0, 1, 3, 4)).gt(0).all())
    assert not state["cache"]["k"][:, :, 31].any()
    _, out = step(state, batch)
    assert out["logits"].shape == (4, cfg.vocab) and bool(torch.isfinite(out["logits"]).all())
    assert state["cache"]["k"][:, :, 31].any()
    with pytest.raises(ValueError, match="no gradient accumulation"):
        lowering.build_cell(cfg, suite, CPU, grad_accum=2)


# ---------------------------------------------------------------------------
# the kernels' entries in the op counters
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _zamba_fwd():
    """K1 at zamba2-7b's serving shape (PERF.md: 240.5 GFLOP, half the square)."""
    q, k, v = _meta(8, 32, 2048, 1, 112), _meta(8, 32, 2048, 112), _meta(8, 32, 2048, 112)
    o, lse = _meta(8, 32, 2048, 1, 112), _meta(8, 32, 2048, 1, dtype=torch.float32)
    return (lambda: fa.record_launch("flash_attention_fwd", fa.fwd_flops, q, k, [q, k, v], [o, lse], causal=True,
                                     q_offset=0),
            240.5e9, 2048, 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel())


def _zamba_bwd(name, flops_of, want):
    """K2, K3 at zamba2-7b's training shape (PERF.md: 481.2, 360.9 GFLOP)."""
    def make():
        q, k, v = _meta(2, 32, 4096, 1, 112), _meta(2, 32, 4096, 112), _meta(2, 32, 4096, 112)
        return lambda: fa.record_launch(name, flops_of, q, k, [q, k, v], [q], causal=True, q_offset=0), want, None, None
    return make


def _zamba_decode():
    """K4 at zamba2-7b's decode shape, kv_len 2064 of 2080 as a device length
    (PERF.md: 236.8 MB)."""
    q, kc, vc, out = _meta(8, 32, 112), _meta(8, 2080, 32, 112), _meta(8, 2080, 32, 112), _meta(8, 32, 112)
    kv_len = torch.tensor([2064], dtype=torch.int32)
    return lambda: da.record_launch(q, kc, vc, kv_len, out), 4 * 112 * 8 * 32 * 2064, None, 236_830_720


def _rwkv_prefill():
    """K5 at rwkv6-1.6b's prefill (B 8, T 2048, H 32; PERF.md's bound 0.1427 ms
    on 3.35 TB/s: 478.2 MB)."""
    B, T, H, K = 8, 2048, 32, rk.HEAD_SIZE
    r, k, v = _meta(B, T, H, K), _meta(B, T, H, K), _meta(B, T, H, K)
    logw, u, s0 = (_meta(*s, dtype=torch.float32) for s in ((B, T, H, K), (H, K), (B, H, K, K)))
    out, state = _meta(B, T, H, K, dtype=torch.float32), _meta(B, H, K, K, dtype=torch.float32)
    return (lambda: rk.record_launch(r, k, v, logw, u, s0, out, state), 4 * K * K * B * T * H, None,
            B * T * H * K * (3 * 2 + 4 + 4) + H * K * 4 + 2 * B * H * K * K * 4)


KERNEL_CASES = {
    "flash_attention_fwd": _zamba_fwd,
    "flash_attention_bwd_dkv": _zamba_bwd("flash_attention_bwd_dkv", fa.bwd_dkv_flops, 481.2e9),
    "flash_attention_bwd_dq": _zamba_bwd("flash_attention_bwd_dq", fa.bwd_dq_flops, 360.9e9),
    "decode_attention": _zamba_decode,
    "wkv6_scan": _rwkv_prefill,
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_formula_at_the_shape_perf_reckons(name):
    """One launch reported under an ``OpLog`` on meta tensors of the shapes of
    ``PERF.md``'s bound column: one entry and nothing else, its FLOPs that
    reckoning (K1-K3 to the printed GFLOP, K1's diagonal besides: the bound
    column reckons half the square, the kernel computes S(S + 1) / 2 pairs a
    head), its bytes (K1, K4, K5) each operand and output once."""
    launch, want, seq, nbytes = KERNEL_CASES[name]()
    with OpLog() as log:
        launch()
    assert len(log.ops) == 1 and log.ops[0].startswith(name) and log.trace[0][0] == name
    got = log.trace[0][3]
    assert log.flops == got
    if seq is not None:  # K1: the printed half square plus the diagonal
        assert got == pytest.approx(want * (1 + 1 / seq), rel=5e-4)
    elif want >= 1e11:  # K2, K3: to the printed GFLOP
        assert round(got / 1e9, 1) == want / 1e9
    else:
        assert got == want
    if nbytes is not None:
        assert log.trace[0][1] + log.trace[0][2] == nbytes
    assert log.product_dtypes[torch.bfloat16] == 1


def test_live_pairs_counts_the_causal_mask():
    for B, H, Sq, Skv, causal, off in [(2, 3, 5, 5, True, 0), (1, 4, 33, 97, True, 64), (1, 2, 131, 77, True, 0),
                                       (1, 1, 5, 40, True, 35), (2, 2, 7, 9, False, 0), (1, 1, 3, 2, True, 7)]:
        want = B * H * sum(min(off + i + 1, Skv) if causal else Skv for i in range(Sq))
        assert fa.live_pairs(B, H, Sq, Skv, causal, off) == want


def test_an_oplog_takes_a_kernel_entry():
    """A hooked entry shows in ``ops`` (so in the fingerprint), ``trace`` (so in
    the traffic model's bytes: the kernels are HBM ops), ``flops`` and
    ``count_step``'s per-kernel tally, and the log's live storages."""
    a, b = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4, 8, dtype=torch.bfloat16)
    assert not counts.recording()
    counts.record_kernel("flash_attention_fwd", [a], [b], 1.0)  # no active log: nothing to report to
    assert counts.KERNEL_OPS <= HBM_OPS

    def step():
        out = torch.empty_like(b)
        assert counts.recording()
        counts.record_kernel("flash_attention_fwd", [a, b], [out], 1234.0)
        return out

    with OpLog() as log:
        step()
    assert any(op.startswith("flash_attention_fwd[(4, 8), (4, 8)]->[(4, 8)]") for op in log.ops)
    assert ("flash_attention_fwd", 128, 64, 1234.0) in log.trace
    assert log.flops == 1234.0
    assert hlo_flops_bytes(log, ())["bytes"] == 128 + 64
    _, c = count_step(step, inputs=())
    assert c.kernels == {"flash_attention_fwd": (1, 1234.0)} and c.flops == 1234.0
    _, c2 = count_step(lambda: torch.empty_like(b), inputs=())
    assert c2.fingerprint != c.fingerprint
    assert not counts.recording()


@pytest.mark.parametrize("name,flops,error", [("no_such_kernel", 1.0, ValueError),
                                              ("decode_attention", float("nan"), ValueError),
                                              ("decode_attention", float("inf"), ValueError),
                                              ("decode_attention", -1.0, ValueError)])
def test_an_entry_the_log_cannot_take_raises(name, flops, error):
    a = torch.zeros(3)
    with OpLog():
        with pytest.raises(error, match="cannot be recorded"):
            counts.record_kernel(name, [a], [a], flops)


def test_off_the_card_the_wrappers_report_nothing():
    """A CPU tensor takes the plain version, counted as aten ops as before:
    no kernel entry, and the products of the plain attention."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 64, generator=gen).bfloat16()
    k, v = (torch.randn(1, 16, 2, 64, generator=gen).bfloat16() for _ in range(2))
    _, c = count_step(lambda: ops.flash_attention(q, k, v, causal=True), inputs=(q, k, v))
    assert c.kernels == {} and c.flops == 2 * 2 * 4 * 16 * 16 * 64  # the whole square, q·k and p·v
    cache = torch.zeros(1, 20, 2, 64, dtype=torch.bfloat16)
    _, c = count_step(lambda: ops.decode_attention(q[:, :1], cache, cache, kv_len=torch.tensor([5])), inputs=())
    assert c.kernels == {}


# ---------------------------------------------------------------------------
# the skip
# ---------------------------------------------------------------------------


def test_state_bytes_counts_params_grads_accumulator_and_moments():
    cfg = get_config("llama3-8b")
    n = build_model(cfg).param_count()
    # bf16 parameters and gradients (a few f32 norm scales), the f32
    # accumulator, two f32 moments: 16 bytes a parameter, within the norms' share
    assert collocate.state_bytes(cfg, 128) == pytest.approx(16 * n, rel=1e-4)
    assert collocate.state_bytes(cfg, 1) == collocate.state_bytes(cfg, 128) - 4 * n


def test_full_size_llama_is_skipped_without_building(tmp_path, monkeypatch, capsys):
    """The reckoned state of full-size llama3-8b (119.7 GiB) exceeds an H100's
    whole memory: nothing is built or measured, no cell is written, and the
    summary lists it. A skip is not a failure."""
    def never(*args, **kwargs):
        raise AssertionError("a skipped workload was built")

    monkeypatch.setattr(partitioner, "device_memory_bytes", lambda device: H100_BYTES)
    monkeypatch.setattr(lowering, "build_cell", never)
    monkeypatch.setattr(collocate, "measure_job", never)
    rc = collocate.main(["--workloads", "llama3-8b", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    need = collocate.state_bytes(get_config("llama3-8b"), 128)
    assert f"[SKIP] llama3-8b: state of {need / 2**30:.1f} GiB exceeds the card's 79.2 GiB" in capsys.readouterr().out
    summary = json.loads((tmp_path / "_summary.json").read_text())
    assert summary == {"cells": 0, "failures": 0,
                       "skipped": [{"workload": "llama3-8b", "state_bytes": need, "budget_bytes": H100_BYTES}]}
    assert [f.name for f in tmp_path.iterdir()] == ["_summary.json"]
    assert math.isclose(need / 2**30, 119.7, abs_tol=0.05)
