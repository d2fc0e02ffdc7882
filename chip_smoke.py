"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card (at the serving shape and at ragged
small shapes), then serves granite-3-2b at its full size through the port's
entry points -- batch 8, prompt 2048, 32 new tokens, random weights from a
seed -- and checks that the run went through the kernels (launch counts) and
agrees with the same run on the non-kernel PyTorch path.

Prints one JSON object per phase, a summary line {"kernels": [...]}, and as
its last line {"ok": true, "device": {...}}. Any failed phase raises: the
exit code is then not 0 and no last line is printed. Needs one CUDA device;
without one it exits 1. Times are CUDA-event medians after a warm-up; every
number is of the card named in the "device" line.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    print("chip_smoke.py needs a CUDA device and found none", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402
from repro_torch.models.module import param_bytes, param_count  # noqa: E402
from repro_torch.runtime.serve_step import pad_cache  # noqa: E402
from repro_torch.sharding.plan import make_plan  # noqa: E402

DEV = torch.device("cuda", 0)

# published peaks of one H100 SXM (dense): what ``bound_ms`` is reckoned against
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the serving shape: granite-3-2b, batch 8, prompt 2048, 32 new tokens
ARCH, BATCH, PROMPT, NEW = "granite-3-2b", 8, 2048, 32

TOL_BF16 = 2e-2   # one bf16 rounding of o, and p rounded to bf16 for p.v
TOL_LSE = 1e-4    # f32 statistics; only summation order and fast exp/log differ
# At the serving shape a softmax over n ~ 2048 random keys averages v down to
# rms ~ sqrt(e/n) ~ 0.04, so an absolute 2e-2 would be as large as the values
# it compares. There the outputs are held, row by row (one head of one token),
# to TOL_ROW_RMS of that row's rms plus one ulp of the output type on the
# element (2^-7 relative for bf16, 2^-10 for f16). For decode at kv_len 2049
# that is about 1e-3 absolute; a kernel that read the dead cache slots past
# kv_len would be off by about 5e-3.
TOL_ROW_RMS = 2e-2
ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
# Logits of the whole model, kernels against the non-kernel path. 6e-2 is the
# reference's own serving tolerance (tests/test_decode_consistency.py), set for
# 2-layer models and, as its note says, for all but <1% of the elements. At the
# full 40 layers the two paths' bf16 roundings (the kernel rounds p to bf16 for
# p.v, the torch path rounds q*scale to bf16 instead) compound through the
# residual stream: measured on an H100, 2 of 393,240 prefill logits lay beyond
# 6e-2, the worst at 0.077. So: 6e-2 for all but 0.1% of the elements, and a hard
# limit of 0.25 for every one. A cache, rotary or position fault gives O(1)
# errors on most elements and fails both.
TOL_LOGITS = 6e-2
TOL_LOGITS_OUTLIERS = 1e-3
TOL_LOGITS_HARD = 0.25


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_ms(fn, *, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the device time of one call, from CUDA events.

    The device is first kept busy with a spin kernel so that the host has
    queued all ``iters`` calls before the first one starts: the events then
    bracket device work only, not the host's launch overhead.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def require(cond, message: str) -> None:
    """A check that stays on under ``python -O`` (a bare assert would not)."""
    if not cond:
        raise AssertionError(message)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          outliers: float = 0.0, hard_tol: float = 0.0) -> float:
    """max |got - want|, after asserting |got - want| <= tol + tol * |want|.

    With ``outliers`` > 0 that share of the elements may lie beyond ``tol``,
    but none beyond ``hard_tol`` (same form).
    """
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite values")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    n_bad = int((diff > tol + tol * w.abs()).sum())
    n_hard = int((diff > hard_tol + hard_tol * w.abs()).sum()) if outliers else n_bad
    if n_bad > outliers * diff.numel() or n_hard:
        raise AssertionError(
            f"{name}: {n_bad} of {diff.numel()} elements beyond atol=rtol={tol} "
            f"(allowed share {outliers}), {n_hard} beyond the hard limit; max abs err {err}"
        )
    return err


def check_rows(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The tolerance scaled to the data: for every row of the last dim,
    |got - want| <= TOL_ROW_RMS * rms(want row) + ulp(dtype) * |want|.

    Returns the max abs error and the largest and the median allowance used.
    """
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite values")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    allowed = TOL_ROW_RMS * w.square().mean(dim=-1, keepdim=True).sqrt() + ULP[got.dtype] * w.abs()
    n_bad = int((diff > allowed).sum())
    if n_bad:
        worst = (diff - allowed).argmax()
        raise AssertionError(
            f"{name}: {n_bad} of {diff.numel()} elements beyond {TOL_ROW_RMS} * rms(row) + 1 ulp; "
            f"worst |diff| {diff.flatten()[worst].item()} where {allowed.flatten()[worst].item()} is allowed"
        )
    return {"max_abs_err": diff.max().item(), "rms_want": w.square().mean().sqrt().item(),
            "allowed_median": allowed.median().item(), "allowed_max": allowed.max().item()}


@contextlib.contextmanager
def torch_attention_path():
    """Inside the block the model's attention calls go to the non-kernel
    PyTorch functions, by rebinding the two names the transformer calls. The
    package itself has no such switch: its dispatch reads only its arguments.
    """
    saved = transformer.flash_attention, transformer.decode_attention
    transformer.flash_attention = attention.xla_flash_attention
    transformer.decode_attention = attention.torch_decode_attention
    try:
        yield
    finally:
        transformer.flash_attention, transformer.decode_attention = saved


def randn(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=DEV, dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
    )
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    resources = {}
    for name, log in _build.ptxas_log.items():
        lines = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split(" registers")[0]) for ln in lines if "Used " in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        resources[name] = {"kernels": len(regs), "max_registers": max(regs, default=None),
                           "spilling": spills}
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_processes=_build.n_compiles,
         libraries=sorted(p.name for p in paths.values()), ptxas=resources)


def flash_case(gen, B, Sq, Skv, H, KVH, D, causal, q_offset=0, dtype=torch.bfloat16, by_rows=False) -> dict:
    """The flash kernel (o and lse) against its plain version at one shape.

    ``by_rows`` holds o to the tolerance scaled to each row (``check_rows``)
    instead of the absolute TOL_BF16, which suits only outputs of order 1.
    """
    q = randn(gen, (B, Sq, H, D), dtype)
    k = randn(gen, (B, Skv, KVH, D), dtype)
    v = randn(gen, (B, Skv, KVH, D), dtype)
    scale = D**-0.5
    o_f, lse_f = fa.flash_attention_fwd(
        ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v),
        causal=causal, scale=scale, q_offset=q_offset,
    )
    torch.cuda.synchronize()
    o_ref, lse_ref = ref.mha_reference_with_lse(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    label = f"flash B{B} Sq{Sq} Skv{Skv} H{H} KVH{KVH} D{D} causal={causal} q_offset={q_offset} {dtype}"
    if by_rows:
        rows = check_rows(label + " o", ops._unfold(o_f), o_ref)
        err_o = rows.pop("max_abs_err")
    else:
        rows = {}
        err_o = check(label + " o", ops._unfold(o_f), o_ref, TOL_BF16)
    # lse (B,KVH,Sq,G) against torch.logsumexp of the f32 scores, (B,Sq,H)
    lse_k = lse_f.permute(0, 2, 1, 3).reshape(B, Sq, H)
    err_lse = check(label + " lse", lse_k, lse_ref, TOL_LSE)
    return {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KVH": KVH, "D": D, "causal": causal,
            "q_offset": q_offset, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err_o, "lse_max_abs_err": err_lse, **rows}


def phase_flash(cfg) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(1)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    launches0 = fa.launch_count

    cases = [
        flash_case(gen, BATCH, PROMPT, PROMPT, H, KVH, D, True, by_rows=True),  # the serving shape
        flash_case(gen, 2, 77, 77, 8, 2, 64, True),                     # ragged, causal
        flash_case(gen, 1, 50, 131, 4, 4, 128, False),                  # ragged, non-causal, D=128
        flash_case(gen, 2, 33, 97, 8, 2, 64, True, q_offset=64),        # q_offset > 0
        flash_case(gen, 1, 130, 130, 6, 2, 64, True, dtype=torch.float16),  # G=3, f16
    ]
    require(fa.launch_count - launches0 == len(cases), "the flash wrapper did not count its launches")

    # timings at the serving shape, through the model-layout wrapper
    q = randn(gen, (BATCH, PROMPT, H, D))
    k = randn(gen, (BATCH, PROMPT, KVH, D))
    v = randn(gen, (BATCH, PROMPT, KVH, D))
    kernel_ms = gpu_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=10)
    plain_ms = gpu_ms(lambda: ref.mha_reference(q, k, v, causal=True), iters=2, reps=3)
    # yardstick only: one library call on the same work (K/V heads expanded beforehand)
    G = H // KVH
    ql = q.permute(0, 2, 1, 3)
    kl = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vl = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True).permute(0, 2, 1, 3)
    lib_err = max_err(o_lib, ops.flash_attention(q, k, v, causal=True))
    library_ms = gpu_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), iters=10)

    flops = 2 * 2 * BATCH * H * PROMPT * PROMPT * D / 2  # causal: half of the full square
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * BATCH * H * PROMPT  # q, o, k, v, lse
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    out = {
        "name": "flash_attention_fwd", "shape": f"q ({BATCH},{KVH},{PROMPT},{G},{D}) k/v ({BATCH},{KVH},{PROMPT},{D}) bf16 causal",
        "tolerance": {"o": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones",
                      "lse": TOL_LSE},
        "max_abs_err": cases[0]["max_abs_err"], "lse_max_abs_err": cases[0]["lse_max_abs_err"],
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "F.scaled_dot_product_attention(is_causal=True), K/V heads expanded beforehand",
        "library_vs_kernel_max_abs_err": lib_err,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_reckoned": f"max({flops:.4g} FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)",
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "cases": cases,
    }
    emit("kernel", **out)
    return out


def phase_decode(cfg) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(2)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    smax = PROMPT + NEW
    launches0 = da.launch_count
    compiles0 = _build.n_compiles
    cases = []

    def case(B, Smax, Hh, KVHh, Dh, lens, dtype=torch.bfloat16, by_rows=False):
        q = randn(gen, (B, Hh, Dh), dtype)
        kc = randn(gen, (B, Smax, KVHh, Dh), dtype)
        vc = randn(gen, (B, Smax, KVHh, Dh), dtype)
        # one device scalar, changed in place between launches: no host sync, no rebuild
        kv_len = torch.zeros(1, dtype=torch.int32, device=DEV)
        for n in lens:
            kv_len.fill_(n)
            got = da.decode_attention(q, kc, vc, kv_len)
            torch.cuda.synchronize()
            want = ref.decode_attention_reference(q, kc, vc, kv_len=n)
            label = f"decode B{B} Smax{Smax} H{Hh} KVH{KVHh} D{Dh} kv_len={n} {dtype}"
            if by_rows:
                rows = check_rows(label, got, want)
                err = rows.pop("max_abs_err")
            else:
                rows = {}
                err = check(label, got, want, TOL_BF16)
            cases.append({"B": B, "Smax": Smax, "H": Hh, "KVH": KVHh, "D": Dh, "kv_len": n,
                          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, **rows})
        # a Python int is wrapped by the wrapper: same launch, same bits
        got_int = da.decode_attention(q, kc, vc, lens[-1])
        require(torch.equal(got_int, got), "decode: kv_len as an int and as a device tensor disagree")
        return len(lens) + 1

    n = case(BATCH, smax, H, KVH, D, [PROMPT + 1, PROMPT + 17, smax], by_rows=True)  # the serving shape
    main_err = max(c["max_abs_err"] for c in cases)
    n += case(2, 333, 8, 2, 64, [1, 77, 200, 333])                      # ragged Smax, mid-block lengths
    n += case(3, 97, 6, 1, 128, [50, 97])                               # MQA, G=6, D=128
    n += case(1, 515, 16, 2, 64, [300], dtype=torch.float16)            # G=8, f16
    require(da.launch_count - launches0 == n, "the decode wrapper did not count its launches")
    require(_build.n_compiles == compiles0, "a new kv_len rebuilt the kernel")

    # timings at the serving shape. As in the model, every layer has its own
    # cache, so a launch finds its 34 MB cold: cycle over more layers than the
    # 50 MB L2 holds.
    layers = 8
    q = randn(gen, (BATCH, H, D))
    kc = randn(gen, (layers, BATCH, smax, KVH, D))
    vc = randn(gen, (layers, BATCH, smax, KVH, D))
    kv_n = PROMPT + NEW // 2
    kv_len = torch.tensor([kv_n], dtype=torch.int32, device=DEV)
    state = {"i": 0}

    def cycle(fn):
        def run():
            i = state["i"] = (state["i"] + 1) % layers
            return fn(kc[i], vc[i])
        return run

    kernel_ms = gpu_ms(cycle(lambda a, b: da.decode_attention(q, a, b, kv_len)), iters=40)
    plain_ms = gpu_ms(cycle(lambda a, b: ref.decode_attention_reference(q, a, b, kv_len=kv_len)), iters=8)
    # yardstick only: one library call over the valid prefix of the cache, in
    # place. Which call is settled by the installed PyTorch (enable_gqa came
    # with 2.5), not by trying: an error of either call stops the run.
    q4 = q[:, :, None, :]
    if tuple(int(x) for x in torch.__version__.split("+")[0].split(".")[:2]) >= (2, 5):
        library_call = "F.scaled_dot_product_attention(enable_gqa=True) on cache[:, :kv_len] in place"

        def lib(a, b):
            return F.scaled_dot_product_attention(
                q4, a[:, :kv_n].permute(0, 2, 1, 3), b[:, :kv_n].permute(0, 2, 1, 3), enable_gqa=True)
    else:
        G = H // KVH
        library_call = "F.scaled_dot_product_attention on cache[:, :kv_len], K/V heads expanded inside the call"

        def lib(a, b):
            return F.scaled_dot_product_attention(
                q4, a[:, :kv_n].permute(0, 2, 1, 3).repeat_interleave(G, dim=1),
                b[:, :kv_n].permute(0, 2, 1, 3).repeat_interleave(G, dim=1))

    lib_err = max_err(lib(kc[0], vc[0])[:, :, 0], da.decode_attention(q, kc[0], vc[0], kv_len))
    library_ms = gpu_ms(cycle(lib), iters=40)

    nbytes = 2 * (2 * BATCH * kv_n * KVH * D) + 2 * 2 * q.numel()  # K and V up to kv_len, q, out
    flops = 2 * 2 * BATCH * H * kv_n * D
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    out = {
        "name": "decode_attention", "shape": f"q ({BATCH},{H},{D}) caches ({BATCH},{smax},{KVH},{D}) bf16 kv_len {kv_n}",
        "tolerance": {"o": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones"},
        "max_abs_err": main_err,
        "kv_splits": da.n_splits(BATCH, KVH, H // KVH, smax, torch.cuda.get_device_properties(0).multi_processor_count),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": library_call, "library_vs_kernel_max_abs_err": lib_err,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_reckoned": f"max({flops:.4g} FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)",
        "achieved_gb_per_s": nbytes / (kernel_ms * 1e-3) / 1e9,
        "cases": cases,
    }
    emit("kernel", **out)
    return out


@torch.no_grad()
def serve(model, params, plan, prompts, forced_tokens=None):
    """Prefill, pad the cache, NEW - 1 decode steps. Returns the last logits of
    prefill and of every decode step, the tokens fed, and host-clock times.

    With ``forced_tokens`` the decode steps are fed those tokens instead of
    their own argmax, so two runs see the same inputs at every step.
    """
    S = prompts.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": prompts}, plan)
    cache = pad_cache(cache, NEW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = [last]
    tokens = [torch.argmax(last, dim=-1).to(torch.int32)]
    for i in range(NEW - 1):
        tok = tokens[-1] if forced_tokens is None else forced_tokens[:, i]
        lg, cache = model.decode(params, {"token": tok}, cache, S + i, plan)
        logits.append(lg)
        tokens.append(torch.argmax(lg, dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {
        "logits": torch.stack(logits, dim=1),  # (B, NEW, V)
        "tokens": torch.stack(tokens, dim=1),  # (B, NEW)
        "cache_shape": tuple(cache["k"].shape),
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_ms_per_step": (t2 - t1) * 1e3 / (NEW - 1),
    }


def phase_serve(cfg) -> dict:
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    prompts = torch.from_numpy(
        synthetic.token_batch(cfg.vocab, BATCH, PROMPT, seed=7)["tokens"]
    ).to(DEV)

    # warm-up (library handles, allocator): a short request, not counted
    with torch.no_grad():
        _, c = model.prefill(params, {"tokens": prompts[:, :256]}, plan)
        c = pad_cache(c, 2)
        model.decode(params, {"token": prompts[:, 0]}, c, 256, plan)
        del c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, through the kernels, with the counts set to 0 just before
    fa.launch_count = 0
    da.launch_count = 0
    run = serve(model, params, plan, prompts)
    flash_launches, decode_launches = fa.launch_count, da.launch_count
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    require(flash_launches == L, f"flash launches {flash_launches}, expected {L}")
    require(decode_launches == L * (NEW - 1), f"decode launches {decode_launches}, expected {L * (NEW - 1)}")
    require(run["logits"].shape == (BATCH, NEW, cfg.padded_vocab), f"logits shape {tuple(run['logits'].shape)}")
    require(run["cache_shape"] == (L, BATCH, PROMPT + NEW, cfg.n_kv_heads, cfg.resolved_head_dim),
            f"cache shape {run['cache_shape']}")
    require(torch.isfinite(run["logits"][..., : cfg.vocab].float()).all(), "non-finite logits")
    require((run["tokens"] >= 0).all() and (run["tokens"] < cfg.vocab).all(), "a greedy token outside the vocab")

    # ---- the same requests on the non-kernel PyTorch path, fed the same tokens
    with torch_attention_path():
        base = serve(model, params, plan, prompts, forced_tokens=run["tokens"])
    require((fa.launch_count, da.launch_count) == (flash_launches, decode_launches), "the non-kernel run launched a kernel")
    got = run["logits"][..., : cfg.vocab]
    want = base["logits"][..., : cfg.vocab]
    err_prefill = check("serve: prefill last logits, kernels vs torch path", got[:, 0], want[:, 0],
                        TOL_LOGITS, TOL_LOGITS_OUTLIERS, TOL_LOGITS_HARD)
    err_decode = check("serve: decode logits, kernels vs torch path", got[:, 1:], want[:, 1:],
                       TOL_LOGITS, TOL_LOGITS_OUTLIERS, TOL_LOGITS_HARD)
    agree = (run["tokens"] == base["tokens"]).float().mean().item()

    out = {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model, "batch": BATCH, "prompt": PROMPT,
        "new_tokens": NEW, "params": param_count(params), "param_gb": param_bytes(params) / 1e9,
        "prefill_ms": run["prefill_ms"], "decode_ms_per_step": run["decode_ms_per_step"],
        "prefill_tokens_per_s": BATCH * PROMPT / (run["prefill_ms"] * 1e-3),
        "decode_tokens_per_s": BATCH / (run["decode_ms_per_step"] * 1e-3),
        "peak_memory_gb": peak_gb,
        "launches": {"flash_attention_fwd": flash_launches, "decode_attention": decode_launches},
        "torch_path": {"prefill_ms": base["prefill_ms"], "decode_ms_per_step": base["decode_ms_per_step"]},
        "logits_tolerance": {"atol=rtol": TOL_LOGITS, "share_allowed_beyond": TOL_LOGITS_OUTLIERS,
                             "hard_limit": TOL_LOGITS_HARD},
        "logits_beyond_tolerance": int(((got.float() - want.float()).abs()
                                        > TOL_LOGITS + TOL_LOGITS * want.float().abs()).sum()),
        "logits_compared": got.numel(), "logits_abs_max": want.float().abs().max().item(),
        "logits_std": want.float().std().item(),
        "prefill_logits_max_abs_err": err_prefill,
        "decode_logits_max_abs_err": err_decode, "greedy_token_agreement": agree,
    }
    emit("serve", **out)
    return out


def main() -> None:
    device = phase_device()
    cfg = get_config(ARCH)
    phase_build()
    flash = phase_flash(cfg)
    decode = phase_decode(cfg)
    torch.cuda.empty_cache()
    served = phase_serve(cfg)

    def row(k, source, replaces):
        return {
            "name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": served["launches"][k["name"]], "max_abs_err": k["max_abs_err"],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }

    print(json.dumps({"kernels": [
        row(flash, "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "src/repro/kernels/flash_attention.py:159"),
        row(decode, "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:126"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
