"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card, at the shape its main path
gives it and at ragged small shapes: K1-K4 at head_dim 64 (granite-3-2b) and
at head_dim 160 (stablelm-12b, with a guard case on the first 160 columns of
buffers 192 wide), K1 and K4 at head_dim 112 (zamba2-7b, a guard case on
buffers 128 wide) and at one query head a KV head (deepseek-moe-16b's and
whisper-base's shapes, K2/K3 at whisper's cross attention), K5 at
rwkv6-1.6b's. Then it drives the port's entry points at full size, random
weights from a seed:

  * serving, granite-3-2b, stablelm-12b, rwkv6-1.6b, deepseek-moe-16b and
    zamba2-7b -- batch 8, prompt 2048, 32 new tokens -- and whisper-base on
    1500 frames, prompt 416; held against the same requests on the
    non-kernel PyTorch path (deepseek's and zamba2's logits relative to the
    spread of two non-kernel paths), and every K1 and K4 call of a served
    run against its plain version on its own inputs;
  * training, granite-3-2b -- batch 2, seq 4096, remat on: one step's loss and
    gradients against the non-kernel path, then TRAIN_STEPS steps through
    ``repro_torch.launch.train.run``, then a run cut at half way and resumed
    (at depth 2) against an uninterrupted one; stablelm-12b and olmoe-1b-7b
    at full width and depth 2, whisper-base at full size -- the same
    one-step check;
  * training, the paper's ResNet trio -- batch 32 at full image size,
    RESNET_STEPS steps each through ``repro_torch.launch.train.run``; one
    step of resnet_small and resnet_medium against the same step on the CPU
    in float64, sound and with symmetric padding planted;
  * the paper's collocation characterization -- ``python -m repro_torch.
    launch.collocate`` for the trio on the card's MIG tree, in a process of
    its own (every cell OK, the solo steps against the training phase's, the
    peaks and ``fits`` against the same jobs measured in this process and
    each instance's budget), then naive collocation measured: k = 2, 4, 7
    processes of resnet_small training together on the card, beside the
    naive model's prediction;
  * the calibration loop -- each kernel family's calibration measurement
    (``kernels/calibration.py``: K1, K4 and K5 at their calibration shapes,
    timed between CUDA events) held against its plain version; then
    ``repro_torch.launch.calibrate --backend kernels --skus h100-80gb`` in
    this process (K1 times each of the catalog's 8 (arch, shape) pairs, whose
    full-device records become ``measured``); then ``repro_torch.launch.
    simulate --seed 0``, the event-driven cluster's default grid, with no
    failed cell.

Each path checks that it went through its kernels (launch counts, set to 0
just before the path and read just after).

Prints one JSON object per phase, a summary line {"kernels": [...]}, and as
its last line {"ok": true, "device": {...}}. Any failed phase raises: the
exit code is then not 0 and no last line is printed. Needs one CUDA device;
without one it exits 1. Kernel times are CUDA-event medians after a warm-up;
serving reports the median of PREFILLS prefills and of the decode steps,
training the median step, each by the host clock and by CUDA events beside
the single-run figures; every number is of the card named in the "device"
line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke.py needs a CUDA device and found none", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs.base import ShapeSuite  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.models import attention, moe, resnet, rwkv6, transformer  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402
from repro_torch.core.device import get_sku  # noqa: E402
from repro_torch.core.instance import JobSpec, measure_job  # noqa: E402
from repro_torch.core.calib.records import CharDB  # noqa: E402
from repro_torch.kernels import calibration  # noqa: E402
from repro_torch.launch import calibrate, collocate, simulate, train  # noqa: E402
from repro_torch.models.module import (  # noqa: E402
    param_bytes, param_count, tree_leaves, tree_map, tree_paths, tree_unflatten,
)
from repro_torch.runtime import train_step  # noqa: E402
from repro_torch.runtime.serve_step import pad_cache  # noqa: E402
from repro_torch.sharding.plan import make_plan  # noqa: E402

DEV = torch.device("cuda", 0)

# published peaks of one H100 SXM (dense): what ``bound_ms`` is reckoned against
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# the serving shape: granite-3-2b, batch 8, prompt 2048, 32 new tokens
ARCH, BATCH, PROMPT, NEW = "granite-3-2b", 8, 2048, 32
# the training shape: batch 2 at the sequence length of the TRAIN_4K suite
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
# head_dim 160: stablelm-12b, served at the same batch, prompt and new tokens,
# and its one-step training check at full width and this depth
STABLELM_ARCH, STABLELM_TRAIN_LAYERS = "stablelm-12b", 2
# the guard cases' buffers: D = 160 columns, then 32 of NaN (inputs) or of
# SENTINEL (outputs)
GUARD_WIDTH, SENTINEL = 192, 7.0
# head_dim 112: zamba2-7b's shared attention block, served at the same batch,
# prompt and new tokens; its guard case on the first 112 columns of buffers
# 128 wide
ZAMBA_ARCH, D112_GUARD_WIDTH = "zamba2-7b", 128
# the mixture of experts: deepseek-moe-16b served at the same batch, prompt and
# new tokens; olmoe-1b-7b's one-step check at full width and this depth
DEEPSEEK_ARCH, OLMOE_ARCH, OLMOE_TRAIN_LAYERS = "deepseek-moe-16b", "olmoe-1b-7b", 2
# the encoder-decoder: whisper-base served at batch 8 with its 1500 frames, a
# prompt of 416 and NEW new tokens (448, the real model's decoder cap), and
# trained one step at batch 8 on 448 tokens
WHISPER_ARCH, WHISPER_FRAMES, WHISPER_PROMPT = "whisper-base", 1500, 416
# K1's launches in one prefill and K4's in the NEW - 1 decode steps of each
# new family: a layer's one attention (deepseek, 28 layers); the shared block
# before each of zamba2's 3 groups; whisper's 6 encoder layers and the self and
# cross attention of its 6 decoder layers
SERVE_LAUNCHES = {"deepseek-moe-16b": (28, 28 * (NEW - 1)), "zamba2-7b": (3, 3 * (NEW - 1)),
                  "whisper-base": (18, 12 * (NEW - 1))}
# the paper's workload trio: batch 32, steps through the launcher, and the
# samples of an epoch (launch/collocate.py: CIFAR-10's 45,000 training images,
# ImageNet's 1,281,167)
RESNET_ARCHS, RESNET_BATCH, RESNET_STEPS = ("resnet_small", "resnet_medium", "resnet_large"), 32, 20
RESNET_EPOCH_SAMPLES = {"resnet_small": 45_000, "resnet_medium": 1_281_167, "resnet_large": 1_281_167}
# the paper's characterization (launch/collocate.py) of the trio on the card's
# MIG tree: a solo step must lie within SOLO_LIMIT of phase_resnet's median
# for the same arch (host-bound medians have moved 37% between runs)
SOLO_LIMIT = 2.0
# naive collocation measured: k processes of NAIVE_ARCH at batch RESNET_BATCH
# on the one card, each warmed up (a 2-step run through the launcher: the CUDA
# context, cuDNN's autotuner) and then released together for NAIVE_STEPS steps
# through the launcher; the steady window starts once every process is past
# its first NAIVE_SKIP steps and ends when the first one finishes
NAIVE_KS, NAIVE_ARCH, NAIVE_STEPS, NAIVE_SKIP = (2, 4, 7), "resnet_small", 30, 2
NAIVE_TIMEOUT_S = 300
# the characterization's command, in a process of its own: its limit, and how
# far its peaks may lie from the same jobs measured in this process
COLLOCATE_TIMEOUT_S, PEAK_LIMIT = 300, 1.25
# a step line of the launcher's log (``--log-every 1``): the step's host ms
STEP_LINE = re.compile(r"\[train\] step (\d+)/\d+ loss=\S+ step_time=([0-9.]+)ms")
# one process of the naive runs: warm-up, "ready", wait for the start file, train
NAIVE_CHILD = """
import sys, time
from pathlib import Path
from repro_torch.launch import train
start, argv = Path(sys.argv[1]), sys.argv[2:]
train.run(train.build_argparser().parse_args(argv + ["--steps", "2", "--log-every", "100", "--metrics-out", ""]))
print("ready", flush=True)
while not start.exists():
    time.sleep(0.005)
sys.argv = ["train"] + argv
train.main()
"""
# the calibration loop's kernels backend on the h100-80gb catalog: its MISO
# probe plan holds CALIB_PAIRS (arch, shape) pairs, every one timed with K1
# (kernels/calibration.py maps the dense archs, the ResNets and whisper-base to
# flash attention); each measure_calibration_kernel call runs its kernel once
# for the error, once to warm up and CALIB_N times timed (KernelBackend's
# n_samples)
CALIB_SKU, CALIB_PAIRS, CALIB_N = "h100-80gb", 8, 2
CALIB_RUNS = 1 + 1 + CALIB_N
# the attention-free family, served at the same batch, prompt and new tokens
RWKV_ARCH = "rwkv6-1.6b"
# the long WKV6 case: one sequence of 512 chunks, 32 (batch, head) pairs
WKV_LONG_T = 32768
# prefills a serving phase times for its median: two before the main path's run, and that run's
PREFILLS = 3

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
TOL_GRAD_FLOOR = 1e-3  # of a gradient tensor's rms, for rows that are 0 by cancellation
ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
# Logits of the whole model, kernels against the non-kernel path. 6e-2 is the
# reference's own serving tolerance (tests/test_decode_consistency.py), set for
# 2-layer models and, as its note says, for all but <1% of the elements. At the
# full 40 layers the two paths' bf16 roundings (the kernel rounds p to bf16 for
# p.v, the torch path rounds q*scale to bf16 instead) compound through the
# residual stream: measured on an H100, 2 of 393,240 prefill logits lay beyond
# 6e-2, the worst at 0.077. So: 6e-2 for all but 0.1% of the elements, and a hard
# limit of 0.25 for every one. A cache, rotary or position fault gives O(1)
# errors on most elements and fails both. rwkv6-1.6b is held to the same
# limits: its two paths (the WKV6 kernel, the plain chunked form) agree to
# about 1e-5 in f32 and differ where the bf16 rounding of the WKV output
# flips; measured on an H100, none of 16.8 M logits beyond 6e-2, the worst
# 0.047. A WKV6 kernel planted with a fault, the state not decayed at chunk
# ends (examples/profile_wkv6_torch.py --variants plant), fails both limits.
TOL_LOGITS = 6e-2
TOL_LOGITS_OUTLIERS = 1e-3
TOL_LOGITS_HARD = 0.25
# deepseek-moe-16b and zamba2-7b cannot be held to those limits. At the
# reference's init (deepseek's experts have a std of 1/sqrt(E) = 0.125, the
# fan-in taken from the leading dim of an (E, d, f) array) a block turns a
# relative difference of its input into a larger one, and depth carries any
# two roundings of attention apart: on an H100 the two non-kernel paths that
# differ in rounding only (``torch_attention_path`` against
# ``f32_attention_path``), routed alike, lie about 8% apart at deepseek's MoE
# input of layer 28 and 8-9% (relative L2) in its prefill's logits, and the
# kernels no farther from the torch path (examples/profile_moe_drift_torch.py);
# zamba2's prefill logits had 17.6% of their elements beyond 6e-2. So these
# two are held to the non-kernel run relative to that spread: the kernel
# run's relative L2 distance from it over the f32 path's, for the prefill's
# and the decode steps' logits each, at most SPREAD_LIMIT. That is a guard
# against gross faults only: with K1's causal mask planted one key too wide
# (`diag_plus_one`) deepseek read 0.980 and 1.003 against 0.944 and 0.996
# sound, as the drift swamps any small fault. What holds the kernels on
# these paths is ``attention_probed``: every K1 and K4 call of a served run
# against its plain version on the model's own inputs.
SPREAD_LIMIT = 2.0
# Training, kernels against the non-kernel path, one step from one init and
# batch: the loss to the reference's own loss tolerance (tests/test_variants.py).
# The gradients by relative L2 error of each leaf, the attention leaves
# (layers/attn/*, and the encoder-decoder's self_attn/* and cross_attn/*) and
# the rest each to a limit of their own. Each limit is the
# geometric mean, rounded down, of two readings of this check on an H100. One
# is the sound kernels: attention 0.0244, the rest 0.0261. The two paths round
# to bf16 at different places, and 40 layers of bf16 backward carry that; the
# readings repeat to 1e-8 from run to run. The other has one fault planted in
# the dq kernel, which skips its diagonal KV tile: attention 0.906, the rest
# 0.162. A fault planted in the dk/dv kernel, which skips the first q tile of
# its sweep, read 0.718 and 0.533 (examples/profile_flash_bwd_torch.py plants
# both); one in the forward kernel, whose causal mask lets each row see one key
# too many, 0.630 and 0.497 (examples/profile_flash_fwd_torch.py). Each
# redesign of the flash kernels moved the sound readings a little (0.0241 and
# 0.0260 with the mma.sync kernels, 0.0245 and 0.0261 with the wgmma backward);
# the limits, recomputed each time, did not move.
# delta = sum_d o*do, the dq kernel's f32 sum against PyTorch's: the products
# of two 16-bit values are exact in f32, so only the order of D additions differs.
TOL_DELTA = 1e-4
TOL_LOSS = 3e-2
TOL_GRAD_ATTN = 0.1
TOL_GRAD_OTHER = 0.06
TOL_RESUME = 1e-5  # the reference's resume tolerance (tests/test_train_integration.py)
# stablelm-12b's one-step check (head_dim 160, full width, depth 2): loss,
# attention leaves, other leaves. The loss keeps the reference's tolerance;
# each gradient limit is the geometric mean, rounded down, of two readings on
# an H100, set as above: the sound kernels 0.0119 (attention) and 0.0116 (the
# rest), and `dq_skip_diag` planted in K3 0.245 and 0.106
# (examples/profile_flash_bwd_torch.py --variants sound dq_skip_diag).
STABLELM_TOL = (TOL_LOSS, 0.053, 0.035)
# The one-step checks of olmoe-1b-7b (full width, depth 2, batch 2, seq 4096)
# and whisper-base (full size, batch 8, 448 tokens on 1500 frames), set the
# same way from two readings on an H100 each (attention leaves, the rest):
# olmoe sound 0.0183 and 0.0182, `dq_skip_diag` planted in K3 0.166 and 0.0859;
# whisper sound 0.0195 and 0.0129, planted 0.910 and 0.276 (the fault hits
# its 6 causal self-attentions, not the 12 non-causal ones). olmoe's
# non-kernel run routes by the kernel run's choices (``routes_recorded``):
# with each run routing on its own the sound reading was 0.130 and 0.143,
# the tokens whose near-tie of two router probabilities flipped between the
# two paths' roundings, and the planted fault moved it only to 0.207.
OLMOE_TOL = (TOL_LOSS, 0.055, 0.039)
WHISPER_TOL = (TOL_LOSS, 0.133, 0.059)
# One ResNet step on the card (f32, cuDNN TF32 off) against the same step on
# the CPU in float64: the loss's relative error and the largest relative L2
# error of a gradient leaf. Each limit is the geometric mean, rounded down, of
# the worse sound reading and the nearer planted one on an H100 (resnet_small,
# resnet_medium; batch 32): sound loss 4.1e-8, 4.2e-7, worst leaf 0.0068,
# 0.018 (a BatchNorm bias in both; the median leaf 0.0050, 0.014);
# symmetric padding planted, loss 1.1e-3, 4.1e-3, worst leaf 1.79, 1.73.
TOL_RESNET_LOSS = 2e-5
TOL_RESNET_GRAD = 0.17
# The WKV6 kernel against its plain version (token by token) run in float64 on
# the same inputs, out and final state: atol = rtol = 5e-5, the reference's own
# wkv6 tolerance (tests/test_kernels.py). The kernel's products run on the
# tensor cores with each f32 operand in three bf16 parts and f32 sums, the rest
# in f32 (ex2.approx for the exps); its CPU model lies within a tenth of the
# limit at every decay tested (tests/test_torch_wkv6_subchunk.py). The plain version's own f32 run is no oracle at that limit:
# with the model's slow decay (about -0.0025 a token) its state sums hundreds
# of tokens one by one, and on an H100 it lay 2.7e-4 from float64 where the
# kernel lay 4.5e-5. Each case reports that f32 run's error beside the kernel's.
TOL_WKV = 5e-5
# Layer 0's WKV6 output in rwkv6 serving, on the run's own r, k, v and logw
# (the first sequence, 4,194,304 elements of out), against float64: TOL_WKV,
# but a share of the elements may lie beyond it, none beyond the hard limit
# (the form of the logits' check). The model's inputs sum larger terms than
# the cases' random ones, and a few elements keep the f32 rounding of those
# sums: on an H100 the sound kernel put 5 elements beyond TOL_WKV (a share of
# 1.2e-6, worst 2.9e-4). Planted faults (examples/profile_wkv6_torch.py): an
# off-diagonal block's wrong reference point put 3.14 M beyond (worst 9.6),
# the state not decayed at chunk ends 3.93 M (worst 534). The share allowed is
# about 80 times the sound reading and 7,500 times below the nearer fault's;
# the hard limit is 20 TOL_WKV, 3.4 times the sound kernel's worst. The f32
# plain version's distance on the same inputs is printed beside the kernel's.
TOL_WKV_SERVED_OUTLIERS = 1e-4
TOL_WKV_SERVED_HARD = 1e-3


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


def host_us_per_call(fn, n: int = 50) -> float:
    """Host time of one call of ``fn``, in microseconds: ``n`` calls queued
    behind a spin kernel, so that none of them waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def require(cond, message: str) -> None:
    """A check that stays on under ``python -O`` (a bare assert would not)."""
    if not cond:
        raise AssertionError(message)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def n_beyond(got: torch.Tensor, want: torch.Tensor, tol: float) -> int:
    """Elements with |got - want| > tol + tol * |want|, in float64."""
    w = want.double()
    return int(((got.double() - w).abs() > tol + tol * w.abs()).sum())


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
    dt = torch.promote_types(torch.float32, torch.promote_types(got.dtype, want.dtype))
    g, w = got.to(dt), want.to(dt)
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


def check_rows(name: str, got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> dict:
    """The tolerance scaled to the data: for every row of the last dim,
    |got - want| <= TOL_ROW_RMS * rms(want row) + ulp(dtype) * |want| + floor.

    ``floor`` is for rows whose true value is 0 by cancellation, where any
    rounding residue would otherwise fail. Returns the max abs error and the
    largest and the median allowance used.
    """
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite values")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    allowed = TOL_ROW_RMS * w.square().mean(dim=-1, keepdim=True).sqrt() + ULP[got.dtype] * w.abs() + floor
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
def attention_rebound(flash, decode):
    """Inside the block the model's attention calls go to ``flash`` and
    ``decode``, by rebinding the two names the transformer (and the families
    built on it) call. The package itself has no such switch: its dispatch
    reads only its arguments."""
    saved = transformer.flash_attention, transformer.decode_attention
    transformer.flash_attention, transformer.decode_attention = flash, decode
    try:
        yield
    finally:
        transformer.flash_attention, transformer.decode_attention = saved


def torch_attention_path():
    """The non-kernel PyTorch attention functions, as a context manager."""
    return attention_rebound(attention.xla_flash_attention, attention.torch_decode_attention)


def f32_attention_path():
    """The plain f32 versions of ``kernels/ref.py`` (no bf16 rounding of
    q * scale or of p), as a context manager: a second non-kernel path that
    differs from ``torch_attention_path`` in rounding only."""
    def flash(q, k, v, *, causal=True, block_k=None, q_offset=0, scale=None, kv_len=None):
        return ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset, scale=scale)

    def decode(q, k_cache, v_cache, *, kv_len, scale=None):
        return ref.decode_attention_reference(q[:, 0], k_cache, v_cache, kv_len=kv_len, scale=scale)[:, None]

    return attention_rebound(flash, decode)


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


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")  # warpgroup MMA, TMA tile load, warp-level mma.sync


def find_cuobjdump():
    """cuobjdump beside nvcc, or in Triton's package; None where neither has one."""
    candidates = []
    with contextlib.suppress(RuntimeError):
        candidates.append(Path(_build.find_nvcc()).parent / "cuobjdump")
    with contextlib.suppress(ImportError):
        import importlib.util

        spec = importlib.util.find_spec("triton")
        if spec is not None and spec.origin:
            candidates.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    return next((str(c) for c in candidates if c.is_file()), None)


def kernel_name(mangled: str) -> str:
    """``kernel<args>`` of a mangled ``*_kernel`` symbol (template arguments
    that are types or integer literals), else the symbol itself. The
    innermost name wins: a kernel in an anonymous namespace follows that
    namespace's name, which holds a hash of the source's path whose digits
    may themselves read as a length ending at ``_kernel``."""
    # every start, so "116" also tries "16" and "6"; the last start first
    for m in reversed(list(re.finditer(r"(?=(\d+))", mangled))):
        n, end = int(m.group(1)), m.start() + len(m.group(1))
        name = mangled[end:end + n]
        if len(name) < n or not name.endswith("_kernel"):
            continue
        rest, args = mangled[end + n:], []
        if rest.startswith("I"):
            rest = rest[1:]
            while rest and not rest.startswith("E"):
                lit, ident = re.match(r"L[a-z](\d+)E", rest), re.match(r"\d+", rest)
                if lit:
                    args.append(lit.group(1))
                    rest = rest[lit.end():]
                elif ident:
                    k = int(ident.group())
                    args.append(rest[ident.end():ident.end() + k])
                    rest = rest[ident.end() + k:]
                else:
                    args.append({"f": "float"}.get(rest[0], rest[0]))
                    rest = rest[1:]
        return f"{name}<{','.join(args)}>" if args else name
    return mangled


def sass_counts(cuobjdump, lib: Path) -> dict:
    """Per kernel of ``lib``: how many SASS instructions of each of SASS_OPS
    it holds, and of local-memory loads and stores (LDL, STL)."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = counts.setdefault(kernel_name(line.split("Function :")[1].strip()),
                                    dict.fromkeys((*SASS_OPS, "LDL", "STL"), 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return counts


def ptxas_by_kernel(log: str) -> dict:
    """Per kernel, what ``ptxas -v`` said: registers, spill bytes, and any
    line that warns of serialized wgmma or an ignored setmaxnreg."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {"registers": None, "spill_bytes": 0, "warnings": []})
        elif cur is not None and "Used " in line and " registers" in line:
            cur["registers"] = int(line.split("Used ")[1].split(" registers")[0])
        elif cur is not None and "spill" in line:
            cur["spill_bytes"] += sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        if "wgmma" in line.lower() or "setmaxnreg" in line.lower():
            # the message names its function, and may come before that function's own lines
            named = re.search(r"function '([\w$]+)'", line)
            where = (out.setdefault(kernel_name(named.group(1)), {"registers": None, "spill_bytes": 0, "warnings": []})
                     if named else cur or out.setdefault("?", {"warnings": []}))
            where["warnings"].append(line.strip())
    return out


def occupancy() -> dict:
    """Per kernel name (as ``kernel_name`` gives it), the blocks one SM holds
    at once, as the CUDA runtime reckons it from registers and shared memory:
    the flash forward and the decode kernel at every (type, D), the latter
    with the clusters of the serving shape's split that the card holds at
    once, and the WKV6 kernel at every (type, V slice)."""
    types = (("__nv_bfloat16", 0), ("__half", 1))
    out = {}
    fwd = _build.load("flash_attention_fwd").flash_attention_fwd_blocks_per_sm
    for tname, dt in types:
        for D in fa.HEAD_DIMS:
            out[f"flash_fwd_kernel<{tname},{D}>"] = {"blocks_per_sm": fwd(D, dt)}
    dec = _build.load("decode_attention").decode_attention_occupancy
    dec.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    cfg = get_config(ARCH)
    G = cfg.n_heads // cfg.n_kv_heads
    ns = da.n_splits(BATCH, cfg.n_kv_heads, G, PROMPT + NEW, _build.sm_count(0))
    for tname, dt in types:
        for D in da.HEAD_DIMS:
            clusters = ctypes.c_int(0)
            blocks = dec(D, dt, ns, ctypes.byref(clusters))
            out[f"decode_kernel<{tname},{D}>"] = {"blocks_per_sm": blocks, f"clusters_of_{ns}_at_once": clusters.value}
    wkv = _build.load("wkv6_scan").wkv6_scan_blocks_per_sm
    for tname, dt in (("__nv_bfloat16", 0), ("float", 1)):
        for n_split in (1, 2, 4):
            out[f"wkv6_kernel<{tname},{rk.HEAD_SIZE // n_split}>"] = {"blocks_per_sm": wkv(n_split, dt)}
    return out


# K1-K3 are built on wgmma and TMA; K4 on TMA; K5 on mma.sync (loads by
# cp.async). The build phase holds each of their instantiations to that, with
# no spill and no wgmma that ptxas serialized.
WGMMA_KERNELS = ("flash_fwd_kernel<", "flash_bwd_dq_kernel<", "flash_bwd_dkv_kernel<")
TMA_KERNELS = WGMMA_KERNELS + ("decode_kernel<",)
HMMA_KERNELS = ("wkv6_kernel<",)


def phase_build(strict: bool = True) -> None:
    """Builds every kernel and prints what ptxas and the SASS show of each,
    and the blocks an SM holds of K1, K4 and K5. ``strict`` (the default)
    fails on a kernel of TMA_KERNELS or HMMA_KERNELS that spills or whose
    wgmma ptxas serialized, on one of TMA_KERNELS that does not load by TMA,
    on one of WGMMA_KERNELS that is not built on wgmma alone, and on one of
    HMMA_KERNELS with no mma.sync (HMMA) in its SASS; a timing of an earlier
    version turns it off."""
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    seconds = time.perf_counter() - t0
    cuobjdump = find_cuobjdump()
    resources = {}
    for name, path in paths.items():
        kernels = ptxas_by_kernel(_build.ptxas_log.get(name, ""))
        sass = sass_counts(cuobjdump, path) if cuobjdump else {}
        for kname in set(kernels) | set(sass):
            kernels.setdefault(kname, {})["sass"] = sass.get(kname, "unavailable")
        resources[name] = {"max_registers": max((k.get("registers") or 0 for k in kernels.values()), default=None),
                           "kernels": kernels}
    occ = occupancy() if strict else {}
    for info in resources.values():
        for kname, k in info["kernels"].items():
            k.update(occ.get(kname, {}))
    emit("build", seconds=round(seconds, 3), nvcc_processes=_build.n_compiles,
         libraries=sorted(p.name for p in paths.values()), cuobjdump=cuobjdump or "unavailable",
         resources=resources)
    if not strict:
        return
    for lib, n_inst in (("flash_attention_fwd", 8), ("flash_attention_bwd", 12), ("decode_attention", 8),
                        ("wkv6_scan", 6)):
        if _build.ptxas_log.get(lib):  # compiled in this process: ptxas spoke of every kernel
            found = [k for k in resources[lib]["kernels"] if k.startswith(TMA_KERNELS + HMMA_KERNELS)]
            require(len(found) == n_inst, f"{lib}: ptxas named {len(found)} of its {n_inst} kernels: {found}")
    for info in resources.values():
        for kname, k in info["kernels"].items():
            if not kname.startswith(TMA_KERNELS + HMMA_KERNELS):
                continue
            require(not k.get("spill_bytes") and not k.get("warnings"), f"{kname} spills or has serialized wgmma: {k}")
            if isinstance(k.get("sass"), dict) and kname.startswith(HMMA_KERNELS):
                require(k["sass"]["HMMA"] > 0, f"{kname} has no tensor-core instruction (HMMA): {k['sass']}")
            elif isinstance(k.get("sass"), dict):
                require(k["sass"]["UTMALDG"] > 0, f"{kname} does not load by TMA: {k['sass']}")
                if kname.startswith(WGMMA_KERNELS):
                    require(k["sass"]["HGMMA"] > 0 and k["sass"]["HMMA"] == 0,
                            f"{kname} is not built on wgmma alone: {k['sass']}")


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


def flash_fwd_timed(gen, B, S, H, KVH, D) -> dict:
    """K1 at one causal bf16 shape, through the model-layout wrapper: its time
    beside the plain version's, one library call's (with the backend it ran)
    and the bound."""
    G = H // KVH
    q = randn(gen, (B, S, H, D))
    k = randn(gen, (B, S, KVH, D))
    v = randn(gen, (B, S, KVH, D))
    kernel_ms = gpu_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=10)
    plain_ms = gpu_ms(lambda: ref.mha_reference(q, k, v, causal=True), iters=2, reps=3)
    # yardstick only: one library call on the same work (K/V heads expanded beforehand)
    ql = q.permute(0, 2, 1, 3)
    kl = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vl = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)

    def lib():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    lib_err = max_err(lib().permute(0, 2, 1, 3), ops.flash_attention(q, k, v, causal=True))
    library_ms = gpu_ms(lib, iters=10)
    backend = sdpa_backend(lib)

    flops = 2 * 2 * B * H * S * S * D / 2  # causal: half of the full square
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S  # q, o, k, v, lse
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "shape": f"q ({B},{KVH},{S},{G},{D}) k/v ({B},{KVH},{S},{D}) bf16 causal",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "F.scaled_dot_product_attention(is_causal=True), K/V heads expanded beforehand",
        "library_backend": backend, "library_vs_kernel_max_abs_err": lib_err,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_reckoned": f"max({flops:.4g} FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)",
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }


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
        flash_case(gen, 1, 300, 300, 16, 2, 128, True),                 # G=8, D=128: many 64-row kv tiles
        flash_case(gen, 1, 5, 40, 130, 1, 64, True, q_offset=35),       # G=130: one position a tile, rows zeroed
    ]
    require(fa.launch_count - launches0 == len(cases), "the flash wrapper did not count its launches")
    out = {
        "name": "flash_attention_fwd",
        "tolerance": {"o": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones",
                      "lse": TOL_LSE},
        "max_abs_err": cases[0]["max_abs_err"], "lse_max_abs_err": cases[0]["lse_max_abs_err"],
        **flash_fwd_timed(gen, BATCH, PROMPT, H, KVH, D),
        "cases": cases,
    }
    emit("kernel", **out)
    return out


def decode_case(gen, B, Smax, H, KVH, D, lens, dtype=torch.bfloat16, by_rows=False) -> list:
    """K4 against its plain version at one shape, at each kv_len of ``lens``
    (one device scalar, changed in place between launches: no host sync, no
    rebuild); then the last length again as a Python int, which must give
    the same bits. Returns one record a length."""
    q = randn(gen, (B, H, D), dtype)
    kc = randn(gen, (B, Smax, KVH, D), dtype)
    vc = randn(gen, (B, Smax, KVH, D), dtype)
    kv_len = torch.zeros(1, dtype=torch.int32, device=DEV)
    cases = []
    for n in lens:
        kv_len.fill_(n)
        got = da.decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        want = ref.decode_attention_reference(q, kc, vc, kv_len=n)
        label = f"decode B{B} Smax{Smax} H{H} KVH{KVH} D{D} kv_len={n} {dtype}"
        if by_rows:
            rows = check_rows(label, got, want)
            err = rows.pop("max_abs_err")
        else:
            rows = {}
            err = check(label, got, want, TOL_BF16)
        cases.append({"B": B, "Smax": Smax, "H": H, "KVH": KVH, "D": D, "kv_len": n,
                      "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, **rows})
    # a Python int is wrapped by the wrapper: same launch, same bits
    got_int = da.decode_attention(q, kc, vc, lens[-1])
    require(torch.equal(got_int, got), "decode: kv_len as an int and as a device tensor disagree")
    return cases


def decode_timed(gen, B, smax, H, KVH, D, kv_n) -> dict:
    """K4 at one bf16 shape and kv_len: its time beside the plain version's,
    one library call's (with the backend it ran) and the bound. As in the
    model, every layer has its own cache, so a launch finds its cache cold:
    the launches cycle over more layers than the 50 MB L2 holds."""
    layers = 8
    q = randn(gen, (B, H, D))
    kc = randn(gen, (layers, B, smax, KVH, D))
    vc = randn(gen, (layers, B, smax, KVH, D))
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
    backend = sdpa_backend(lambda: lib(kc[0], vc[0]))

    nbytes = 2 * (2 * B * kv_n * KVH * D) + 2 * 2 * q.numel()  # K and V up to kv_len, q, out
    flops = 2 * 2 * B * H * kv_n * D
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "shape": f"q ({B},{H},{D}) caches ({B},{smax},{KVH},{D}) bf16 kv_len {kv_n}",
        "kv_splits": da.n_splits(B, KVH, H // KVH, smax, _build.sm_count(0)),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": library_call, "library_backend": backend, "library_vs_kernel_max_abs_err": lib_err,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_reckoned": f"max({flops:.4g} FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)",
        "achieved_gb_per_s": nbytes / (kernel_ms * 1e-3) / 1e9,
    }


def phase_decode(cfg) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(2)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    smax = PROMPT + NEW
    launches0 = da.launch_count
    compiles0 = _build.n_compiles
    cases = decode_case(gen, BATCH, smax, H, KVH, D, [PROMPT + 1, PROMPT + 17, smax], by_rows=True)  # serving
    main_err = max(c["max_abs_err"] for c in cases)
    cases += decode_case(gen, 2, 333, 8, 2, 64, [1, 77, 200, 333])                      # ragged Smax, mid-block lengths
    cases += decode_case(gen, 3, 97, 6, 1, 128, [50, 97])                               # MQA, G=6, D=128
    cases += decode_case(gen, 1, 515, 16, 2, 64, [300], dtype=torch.float16)            # G=8, f16
    require(da.launch_count - launches0 == len(cases) + 4, "the decode wrapper did not count its launches")
    require(_build.n_compiles == compiles0, "a new kv_len rebuilt the kernel")
    out = {
        "name": "decode_attention",
        "tolerance": {"o": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones"},
        "max_abs_err": main_err,
        **decode_timed(gen, BATCH, smax, H, KVH, D, PROMPT + NEW // 2),
        "cases": cases,
    }
    emit("kernel", **out)
    return out


def live_pairs(B, H, Sq, Skv, causal, q_offset=0) -> int:
    """(query row, key) pairs that attention does not mask, over all heads."""
    if not causal:
        return B * H * Sq * Skv
    per_row = torch.clamp(q_offset + torch.arange(Sq) + 1, max=Skv)
    return B * H * int(per_row.sum())


def flash_bwd_case(gen, B, Sq, Skv, H, KVH, D, causal, q_offset=0, dtype=torch.bfloat16,
                   by_rows=False, repeat=False) -> dict:
    """Both backward kernels against their plain version, fed the same q, k, v,
    do and the forward kernel's o and lse; and that forward (K1) against its
    own plain version at the same shape, before the backward uses it. With
    ``repeat`` the backward runs a second time on the same inputs and must
    give the same bits."""
    q = randn(gen, (B, Sq, H, D), dtype)
    k = randn(gen, (B, Skv, KVH, D), dtype)
    v = randn(gen, (B, Skv, KVH, D), dtype)
    do = randn(gen, (B, Sq, H, D), dtype)
    scale = D**-0.5
    qf, kf, vf, dof = ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), ops._fold(do, KVH)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    label = f"flash bwd B{B} Sq{Sq} Skv{Skv} H{H} KVH{KVH} D{D} causal={causal} q_offset={q_offset} {dtype}"
    out = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KVH": KVH, "D": D, "causal": causal,
           "q_offset": q_offset, "dtype": str(dtype).replace("torch.", "")}

    o, lse = fa.flash_attention_fwd(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = ref.mha_reference_with_lse(q, k, v, **kw)
    if by_rows:
        out["o_max_abs_err"] = check_rows(f"{label} forward o", ops._unfold(o), o_ref)["max_abs_err"]
    else:
        out["o_max_abs_err"] = check(f"{label} forward o", ops._unfold(o), o_ref, TOL_BF16)
    out["lse_max_abs_err"] = check(f"{label} forward lse", lse.permute(0, 2, 1, 3).reshape(B, Sq, H),
                                   lse_ref, TOL_LSE)
    del o_ref, lse_ref

    dkv0, dq0 = fa.dkv_launch_count, fa.dq_launch_count
    dq, dk, dv = fa.flash_attention_bwd(qf, kf, vf, o, lse, dof, **kw)
    torch.cuda.synchronize()
    require((fa.dkv_launch_count - dkv0, fa.dq_launch_count - dq0) == (1, 1),
            "the backward wrapper did not count one launch of each kernel")
    if repeat:
        again = fa.flash_attention_bwd(qf, kf, vf, o, lse, dof, **kw)
        out["repeat_bit_identical"] = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        require(out["repeat_bit_identical"], f"{label}: a second run gave other bits")
        del again
    want = ref.flash_attention_bwd_reference(qf, kf, vf, o, lse, dof, **kw)
    # dq row by row per (token, head); dk, dv per (kv row, kv head). The dq
    # row of the first query position is 0 in exact arithmetic (its softmax
    # has one key, so dp = delta): there the f32 residue of dp - delta is
    # allowed up to TOL_GRAD_FLOOR of the tensor's rms.
    for name, got, ref_ in (("dq", ops._unfold(dq), ops._unfold(want[0])),
                            ("dk", dk, want[1]), ("dv", dv, want[2])):
        if by_rows:
            floor = TOL_GRAD_FLOOR * ref_.float().square().mean().sqrt().item()
            rows = check_rows(f"{label} {name}", got, ref_, floor)
            out[f"{name}_max_abs_err"] = rows["max_abs_err"]
            out[f"{name}_allowed_median"] = rows["allowed_median"]
        else:
            out[f"{name}_max_abs_err"] = check(f"{label} {name}", got, ref_, TOL_BF16)
    return out


def sdpa_backend(fn) -> str:
    """The scaled_dot_product_attention backend that ``fn`` ran, read from the
    names of the aten operators a CPU-side profile of one call records."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    found = sorted(n for n in names if n.startswith("aten::_scaled_dot_product") or "_attention_backward" in n)
    return ", ".join(found) or "unknown"


def flash_bwd_timed(gen, B, S, H, KVH, D) -> tuple:
    """K2 and K3 at one causal bf16 shape: each one's time beside the plain
    version's, the backward of one library call (with the backend it ran)
    and the bound; K3's delta against the plain sum. Returns (K2's record,
    K3's record)."""
    G = H // KVH
    q = randn(gen, (B, S, H, D))
    k = randn(gen, (B, S, KVH, D))
    v = randn(gen, (B, S, KVH, D))
    do = randn(gen, (B, S, H, D))
    scale = D**-0.5
    qf, kf, vf, dof = ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), ops._fold(do, KVH)
    kw = dict(causal=True, scale=scale)
    o, lse = fa.flash_attention_fwd(qf, kf, vf, **kw)
    delta = torch.full_like(lse, float("nan"))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dqf, dkf, dvf = ops._fold(dq, KVH), ops._kv_fold(dk), ops._kv_fold(dv)
    run_dq = lambda: fa.launch_bwd_dq(qf, kf, vf, o, dof, lse, delta, dqf, **kw)  # noqa: E731
    run_dkv = lambda: fa.launch_bwd_dkv(qf, kf, vf, dof, lse, delta, dkf, dvf, **kw)  # noqa: E731
    run_fwd = lambda: fa.flash_attention_fwd(qf, kf, vf, **kw)  # noqa: E731
    # K3's delta against the plain sum of the same f32 products
    run_dq()
    delta_err = check(f"flash bwd delta (dq kernel) at ({B},{S},{H},{KVH},{D})", delta,
                      (o.float() * dof.float()).sum(dim=-1), TOL_DELTA)
    dq_ms = gpu_ms(run_dq, iters=10)
    dkv_ms = gpu_ms(run_dkv, iters=10)
    wrapper_ms = gpu_ms(lambda: fa.flash_attention_bwd(qf, kf, vf, o, lse, dof, **kw), iters=10)
    fwd_ms = gpu_ms(run_fwd, iters=10)  # K1 at this shape
    host_us = {"dq": host_us_per_call(run_dq), "dkv": host_us_per_call(run_dkv),
               "fwd (K1: the same checks, no tensor maps)": host_us_per_call(run_fwd)}
    plain_ms = gpu_ms(lambda: ref.flash_attention_bwd_reference(qf, kf, vf, o, lse, dof, **kw),
                      iters=1, reps=3)
    torch.cuda.empty_cache()

    # yardstick only: the backward of one library call, its forward time subtracted
    ql = q.permute(0, 2, 1, 3).detach().requires_grad_()
    kl = k.permute(0, 2, 1, 3).detach().requires_grad_()
    vl = v.permute(0, 2, 1, 3).detach().requires_grad_()
    dol = do.permute(0, 2, 1, 3)

    def lib_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), (ql, kl, vl), dol)

    lib_grads = lib_fwd_bwd()
    lib_err = max(max_err(lib_grads[0].permute(0, 2, 1, 3), dq),
                  max_err(lib_grads[1].permute(0, 2, 1, 3), dk),
                  max_err(lib_grads[2].permute(0, 2, 1, 3), dv))
    backend = sdpa_backend(lib_fwd_bwd)
    lib_fwd_ms = gpu_ms(lib_fwd, iters=10)
    library_ms = gpu_ms(lib_fwd_bwd, iters=10) - lib_fwd_ms
    del lib_grads, ql, kl, vl

    pairs = live_pairs(B, H, S, S, True)
    in_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * 2 * B * H * S  # q, do, k, v, lse, delta
    outs = []
    for name, ms, flop_per_pair, out_bytes, replaces in (
        ("flash_attention_bwd_dkv", dkv_ms, 8 * D, 2 * (k.numel() + v.numel()),
         "src/repro/kernels/flash_attention.py:352"),
        ("flash_attention_bwd_dq", dq_ms, 6 * D, 2 * q.numel(),
         "src/repro/kernels/flash_attention.py:378"),
    ):
        flops, nbytes = pairs * flop_per_pair, in_bytes + out_bytes
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        outs.append({
            "name": name, "replaces": replaces,
            "shape": f"q/do ({B},{KVH},{S},{G},{D}) k/v ({B},{KVH},{S},{D}) bf16 causal",
            "kernel_ms": ms, "plain_ms": plain_ms,
            "plain_call": "ref.flash_attention_bwd_reference (dq, dk and dv in one call)",
            "wrapper_ms": wrapper_ms, "wrapper_call": "fa.flash_attention_bwd: both kernels (delta in the dq kernel)",
            "dq_plus_dkv_ms": dq_ms + dkv_ms, "delta_max_abs_err": delta_err, "delta_tolerance": TOL_DELTA,
            "host_us_per_launch": host_us,
            "host_us_reckoned": "host clock over 50 launches queued behind a spin kernel, Python wrapper included",
            "forward_kernel_ms": fwd_ms,
            "library_ms": library_ms,
            "library_call": "backward of F.scaled_dot_product_attention(is_causal=True, enable_gqa=True), "
                            "its forward subtracted (dq, dk and dv in one call)",
            "library_backend": backend, "library_forward_ms": lib_fwd_ms,
            "library_vs_kernel_max_abs_err": lib_err,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_reckoned": f"max({flops:.4g} FLOP ({flop_per_pair} x {pairs} live pairs) / 989 TFLOP/s, "
                              f"{nbytes:.4g} B / 3.35 TB/s)",
            "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        })
    return tuple(outs)


def bwd_records(timed_: tuple, main: dict, cases) -> list:
    """K2's and K3's records: ``timed_`` from ``flash_bwd_timed`` with the
    errors of ``main`` (the ``flash_bwd_case`` at the same shape)."""
    errs = ({"dk": main["dk_max_abs_err"], "dv": main["dv_max_abs_err"]}, {"dq": main["dq_max_abs_err"]})
    return [dict(rec, max_abs_err=max(e.values()), errors=e,
                 tolerance=f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones",
                 forward_max_abs_err={"o": main["o_max_abs_err"], "lse": main["lse_max_abs_err"]},
                 cases=cases if i == 0 else "as above")
            for i, (rec, e) in enumerate(zip(timed_, errs))]


def phase_flash_bwd(cfg) -> list:
    """K2 (dk/dv) and K3 (dq) at the training shape and at ragged small shapes."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = TRAIN_BATCH, TRAIN_SEQ
    cases = [
        flash_bwd_case(gen, B, S, S, H, KVH, D, True, by_rows=True, repeat=True),  # the training shape, twice
        flash_bwd_case(gen, 1, 100, 100, 4, 4, 64, True),                # G=1, ragged
        flash_bwd_case(gen, 2, 100, 100, 6, 2, 64, True),                # G=3
        flash_bwd_case(gen, 1, 100, 100, 16, 2, 64, False),              # G=8, non-causal
        flash_bwd_case(gen, 2, 100, 100, 8, 2, 64, True, q_offset=64),   # q_offset > 0
        flash_bwd_case(gen, 1, 100, 100, 8, 2, 128, True),               # head_dim 128
        flash_bwd_case(gen, 1, 100, 100, 6, 2, 64, True, dtype=torch.float16),  # f16
        flash_bwd_case(gen, 1, 100, 100, 4, 1, 128, False, q_offset=64, dtype=torch.float16),
    ]
    torch.cuda.empty_cache()
    outs = bwd_records(flash_bwd_timed(gen, B, S, H, KVH, D), cases[0], cases)
    for out in outs:
        emit("kernel", **out)
    return outs


def padded(gen, shape, dtype, fill, width=GUARD_WIDTH) -> torch.Tensor:
    """A (..., D) tensor that is the first D columns of a buffer ``width``
    wide whose other columns hold ``fill``: random values, or ``fill`` too
    where ``gen`` is None."""
    buf = torch.full((*shape[:-1], width), fill, dtype=dtype, device=DEV)
    if gen is not None:
        buf[..., : shape[-1]] = randn(gen, shape, dtype)
    return buf[..., : shape[-1]]


def pad_intact(name: str, view: torch.Tensor, width=GUARD_WIDTH) -> None:
    """The columns of ``view``'s buffer past its last one still hold SENTINEL."""
    D = view.shape[-1]
    buf = view.as_strided((*view.shape[:-1], width), view.stride())
    require(bool((buf[..., D:] == SENTINEL).all()), f"{name}: the kernel wrote past column {D}")


def guard_case(gen, B=2, S=77, H=8, KVH=2, D=160, Smax=131, kv_n=100, width=GUARD_WIDTH, backward=True) -> dict:
    """K1-K4 (K1 and K4 alone without ``backward``) on the first D columns of
    buffers ``width`` wide: every input's other columns hold NaN, every
    output's a sentinel. Each output is held to its plain version at TOL_BF16
    and its buffer's other columns must still hold the sentinel: a kernel
    that reads past D gives NaN, one that writes past D changes the sentinel."""
    nan, dt = float("nan"), torch.bfloat16
    q, k, v, do = (padded(gen, shape, dt, nan, width) for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                                                                    (B, S, H, D)))
    o, dq, dk, dv = (padded(None, x.shape, dt, SENTINEL, width) for x in (q, q, k, v))
    qf, kf, vf, dof, of = ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), ops._fold(do, KVH), ops._fold(o, KVH)
    kw = dict(causal=True, scale=D**-0.5)
    label = f"guard B{B} S{S} H{H} KVH{KVH} D{D} in buffers {width} wide"
    _, lse = fa.flash_attention_fwd(qf, kf, vf, out=of, **kw)
    if backward:
        delta = torch.empty_like(lse)
        fa.launch_bwd_dq(qf, kf, vf, of, dof, lse, delta, ops._fold(dq, KVH), **kw)
        fa.launch_bwd_dkv(qf, kf, vf, dof, lse, delta, ops._kv_fold(dk), ops._kv_fold(dv), **kw)
    qd, kc, vc = (padded(gen, shape, dt, nan, width) for shape in ((B, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
    od = padded(None, qd.shape, dt, SENTINEL, width)
    da.decode_attention(qd, kc, vc, kv_n, out=od)
    torch.cuda.synchronize()

    o_ref, lse_ref = ref.mha_reference_with_lse(q, k, v, **kw)
    out = {"B": B, "S": S, "H": H, "KVH": KVH, "D": D, "buffer_width": width, "decode_Smax": Smax,
           "decode_kv_len": kv_n,
           "flash_attention_fwd": check(f"{label} K1 o", o, o_ref, TOL_BF16),
           "flash_attention_fwd_lse": check(f"{label} K1 lse", lse.permute(0, 2, 1, 3).reshape(B, S, H), lse_ref,
                                            TOL_LSE),
           "decode_attention": check(f"{label} K4", od, ref.decode_attention_reference(qd, kc, vc, kv_len=kv_n),
                                     TOL_BF16)}
    outputs = [("K1 o", o), ("K4 out", od)]
    if backward:
        want = ref.flash_attention_bwd_reference(qf, kf, vf, of, lse, dof, **kw)
        out["flash_attention_bwd_dq"] = check(f"{label} K3 dq", dq, ops._unfold(want[0]), TOL_BF16)
        out["flash_attention_bwd_dkv"] = max(check(f"{label} K2 dk", dk, want[1].permute(0, 2, 1, 3), TOL_BF16),
                                             check(f"{label} K2 dv", dv, want[2].permute(0, 2, 1, 3), TOL_BF16))
        outputs += [("K3 dq", dq), ("K2 dk", dk), ("K2 dv", dv)]
    for name, x in outputs:
        pad_intact(f"{label} {name}", x, width)
    return out


def olmoe_train_config():
    """olmoe-1b-7b at full width and OLMOE_TRAIN_LAYERS layers: the one-step
    check of the MoE family (K1-K3 at head_dim 128, G = 1)."""
    return dataclasses.replace(get_config(OLMOE_ARCH), n_layers=OLMOE_TRAIN_LAYERS)


def stablelm_train_config():
    """stablelm-12b at full width and STABLELM_TRAIN_LAYERS layers: the
    one-step check at head_dim 160."""
    return dataclasses.replace(get_config(STABLELM_ARCH), n_layers=STABLELM_TRAIN_LAYERS)


def phase_d160(cfg) -> dict:
    """K1-K4 at head_dim 160 (stablelm-12b): each at the shape its main path
    gives it (timed beside its bound and the library call for the same
    function) and at ragged small shapes, then the guard case. Returns each
    kernel's record by name."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    require(D == 160, f"{cfg.name} has head_dim {D}")
    f16 = torch.float16
    fa0, da0 = fa.launch_count, da.launch_count
    fwd_cases = [
        flash_case(gen, BATCH, PROMPT, PROMPT, H, KVH, D, True, by_rows=True),  # the serving shape
        flash_case(gen, 2, 77, 77, 8, 2, D, True),                              # ragged, causal, G=4
        flash_case(gen, 1, 50, 131, 4, 4, D, False),                            # ragged, non-causal, G=1
        flash_case(gen, 2, 33, 97, 8, 2, D, True, q_offset=64),                 # q_offset > 0
        flash_case(gen, 1, 130, 130, 6, 2, D, True, dtype=f16),              # G=3, f16
        flash_case(gen, 1, 5, 40, 130, 1, D, True, q_offset=35),                # G=130: one position a tile
    ]
    require(fa.launch_count - fa0 == len(fwd_cases), "the flash wrapper did not count its launches")
    smax = PROMPT + NEW
    dec_cases = decode_case(gen, BATCH, smax, H, KVH, D, [PROMPT + 1, PROMPT + 17, smax], by_rows=True)
    dec_main = max(c["max_abs_err"] for c in dec_cases)
    dec_cases += decode_case(gen, 2, 333, 8, 2, D, [1, 77, 333])                # ragged Smax, G=4
    dec_cases += decode_case(gen, 3, 97, 6, 1, D, [50, 97], dtype=f16)       # MQA, G=6, f16
    dec_cases += decode_case(gen, 1, 515, 4, 4, D, [300])                       # G=1
    require(da.launch_count - da0 == len(dec_cases) + 4, "the decode wrapper did not count its launches")
    bwd_cases = [
        flash_bwd_case(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, KVH, D, True, by_rows=True, repeat=True),
        flash_bwd_case(gen, 1, 100, 100, 4, 4, D, True),                        # G=1, ragged
        flash_bwd_case(gen, 2, 77, 77, 8, 2, D, False),                         # non-causal
        flash_bwd_case(gen, 2, 100, 100, 8, 2, D, True, q_offset=64),           # q_offset > 0
        flash_bwd_case(gen, 1, 100, 100, 6, 2, D, True, dtype=f16),          # G=3, f16
        flash_bwd_case(gen, 1, 130, 130, 8, 2, D, True),                        # three dk/dv blocks of 64 rows
    ]
    torch.cuda.empty_cache()
    guard = guard_case(gen)
    tol = f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones and the guard case"
    recs = {
        "flash_attention_fwd": {"name": "flash_attention_fwd", "tolerance": tol,
                                "max_abs_err": fwd_cases[0]["max_abs_err"],
                                "lse_max_abs_err": fwd_cases[0]["lse_max_abs_err"],
                                **flash_fwd_timed(gen, BATCH, PROMPT, H, KVH, D), "cases": fwd_cases},
        "decode_attention": {"name": "decode_attention", "tolerance": tol, "max_abs_err": dec_main,
                             **decode_timed(gen, BATCH, smax, H, KVH, D, PROMPT + NEW // 2), "cases": dec_cases},
    }
    torch.cuda.empty_cache()
    for rec in bwd_records(flash_bwd_timed(gen, TRAIN_BATCH, TRAIN_SEQ, H, KVH, D), bwd_cases[0], bwd_cases):
        recs[rec["name"]] = dict(rec, tolerance=tol)
    for name, rec in recs.items():
        rec["guard_max_abs_err"] = guard[name]
        emit("kernel_d160", arch=cfg.name, **rec)
    emit("guard_d160", **guard)
    torch.cuda.empty_cache()
    return recs


def phase_d112(cfg) -> dict:
    """K1 and K4 at head_dim 112 (zamba2-7b's shared attention block; K2 and
    K3 are not built for it): each at the shape its main path gives it (timed
    beside its bound, its plain version and the library call for the same
    function), at ragged small shapes (causal and not, q_offset > 0, G 1, 4
    and 130, f16), then the guard case on the first 112 columns of buffers
    D112_GUARD_WIDTH wide. Returns each kernel's record by name."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    require(D == 112, f"{cfg.name} has head_dim {D}")
    f16 = torch.float16
    fa0, da0 = fa.launch_count, da.launch_count
    fwd_cases = [
        flash_case(gen, BATCH, PROMPT, PROMPT, H, KVH, D, True, by_rows=True),  # the serving shape, G=1
        flash_case(gen, 2, 100, 100, 4, 4, D, True),                            # ragged, causal, G=1
        flash_case(gen, 2, 77, 77, 8, 2, D, True),                              # ragged, causal, G=4
        flash_case(gen, 1, 50, 131, 4, 4, D, False),                            # ragged, non-causal, G=1
        flash_case(gen, 2, 33, 97, 8, 2, D, True, q_offset=64),                 # q_offset > 0
        flash_case(gen, 1, 130, 130, 6, 2, D, True, dtype=f16),                 # G=3, f16
        flash_case(gen, 1, 5, 40, 130, 1, D, True, q_offset=35),                # G=130: one position a tile
    ]
    require(fa.launch_count - fa0 == len(fwd_cases), "the flash wrapper did not count its launches")
    smax = PROMPT + NEW
    dec_cases = decode_case(gen, BATCH, smax, H, KVH, D, [PROMPT + 1, PROMPT + 17, smax], by_rows=True)
    dec_main = max(c["max_abs_err"] for c in dec_cases)
    dec_cases += decode_case(gen, 2, 333, 4, 4, D, [1, 77, 333])                # ragged Smax, G=1
    dec_cases += decode_case(gen, 2, 333, 8, 2, D, [77, 200])                   # G=4
    dec_cases += decode_case(gen, 3, 97, 6, 1, D, [50, 97], dtype=f16)          # MQA, G=6, f16
    dec_cases += decode_case(gen, 1, 300, 130, 1, D, [250])                     # G=130: 17 blocks of 8 heads
    require(da.launch_count - da0 == len(dec_cases) + 5, "the decode wrapper did not count its launches")
    torch.cuda.empty_cache()
    guard = guard_case(gen, D=D, width=D112_GUARD_WIDTH, backward=False)
    tol = f"{TOL_ROW_RMS} * rms(row) + 1 ulp at this shape, {TOL_BF16} at the small ones and the guard case"
    recs = {
        "flash_attention_fwd": {"name": "flash_attention_fwd", "tolerance": tol,
                                "max_abs_err": fwd_cases[0]["max_abs_err"],
                                "lse_max_abs_err": fwd_cases[0]["lse_max_abs_err"],
                                **flash_fwd_timed(gen, BATCH, PROMPT, H, KVH, D), "cases": fwd_cases},
        "decode_attention": {"name": "decode_attention", "tolerance": tol, "max_abs_err": dec_main,
                             **decode_timed(gen, BATCH, smax, H, KVH, D, PROMPT + NEW // 2), "cases": dec_cases},
    }
    for name, rec in recs.items():
        rec["guard_max_abs_err"] = guard[name]
        emit("kernel_d112", arch=cfg.name, **rec)
    emit("guard_d112", **guard)
    torch.cuda.empty_cache()
    return recs


def phase_g1() -> dict:
    """K1, K4 and K2/K3 at the shapes of the multi-head configs (one query head
    a KV head, G = 1), which the dense paths never give them: K4 at head_dim
    128 (deepseek-moe-16b's decode) and 64 (whisper-base's self and cross
    decode, the cross at kv_len 1500); K1 at deepseek's prefill and whisper's
    encoder (1500 x 1500, non-causal) and cross attention (416 x 1500,
    non-causal); K2 and K3 at whisper's cross attention in training (448 x
    1500, non-causal) and at a ragged one. K1 at deepseek's prefill and K4 at
    its decode are timed beside their bounds and the library call."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    flash = [
        flash_case(gen, BATCH, PROMPT, PROMPT, 16, 16, 128, True, by_rows=True),           # deepseek prefill
        flash_case(gen, BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, False, by_rows=True),  # whisper encoder
        flash_case(gen, BATCH, WHISPER_PROMPT, WHISPER_FRAMES, 8, 8, 64, False, by_rows=True),  # whisper cross
        flash_case(gen, 2, 77, 131, 4, 4, 64, False),                                      # ragged, Sq < Skv
        flash_case(gen, 2, 131, 77, 4, 4, 128, False),                                     # ragged, Sq > Skv
    ]
    decode = decode_case(gen, BATCH, PROMPT + NEW, 16, 16, 128, [PROMPT + 1, PROMPT + NEW], by_rows=True)
    decode += decode_case(gen, BATCH, WHISPER_PROMPT + NEW, 8, 8, 64, [WHISPER_PROMPT + 1, WHISPER_PROMPT + NEW],
                          by_rows=True)
    decode += decode_case(gen, BATCH, WHISPER_FRAMES, 8, 8, 64, [WHISPER_FRAMES], by_rows=True)
    decode += decode_case(gen, 2, 333, 4, 4, 128, [1, 77, 333])
    torch.cuda.empty_cache()
    bwd = [
        flash_bwd_case(gen, BATCH, WHISPER_PROMPT + NEW, WHISPER_FRAMES, 8, 8, 64, False, by_rows=True, repeat=True),
        flash_bwd_case(gen, 2, 100, 77, 4, 4, 64, False),
        flash_bwd_case(gen, 1, 77, 130, 4, 4, 128, False),
    ]
    torch.cuda.empty_cache()
    out = {"flash_attention_fwd": flash, "decode_attention": decode, "flash_attention_bwd": bwd,
           "timed_flash_attention_fwd_deepseek": flash_fwd_timed(gen, BATCH, PROMPT, 16, 16, 128),
           "timed_decode_attention_deepseek": decode_timed(gen, BATCH, PROMPT + NEW, 16, 16, 128, PROMPT + NEW // 2),
           "tolerance": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at the model shapes, {TOL_BF16} at the small ones"}
    emit("kernel_g1", **out)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def full_f32_matmul():
    """Inside the block f32 matrix products run in full f32, TF32 off (the
    default for matmul; set here so the plain versions do not depend on it)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def wkv6_inputs(gen, B, T, H, dtype=torch.bfloat16, *, state=False, decay="test", width=64):
    """r, k, v (in ``dtype``), logw, u, state0 (f32), K = V = 64.

    ``width`` > 64 gives r, k, v and logw as the first 64 columns of arrays
    ``width`` wide (rows ``width`` elements apart).

    ``decay``: "test" is the reference's kernel test, logw = -exp(N/2 - 2)
    (about -0.14); "model" the model's decay at init, -exp(-6 + N/10) (about
    -0.0025, a state that remembers hundreds of tokens); a float is a constant
    logw (-3 is the reference's strong-decay test).
    """
    K = rk.HEAD_SIZE
    r, k, v = ((randn(gen, (B, T, H, K), torch.float32) * 0.5).to(dtype) for _ in range(3))
    z = randn(gen, (B, T, H, K), torch.float32)
    if decay == "test":
        logw = -torch.exp(z * 0.5 - 2.0)
    elif decay == "model":
        logw = -torch.exp(z * 0.1 - 6.0)
    else:
        logw = torch.full_like(z, float(decay))
    if width != K:
        r, k, v, logw = (torch.cat([x, x[..., : width - K]], -1)[..., :K] for x in (r, k, v, logw))
    u = randn(gen, (H, K), torch.float32) * 0.2
    s0 = (randn(gen, (B, H, K, K), torch.float32) * 0.3 if state
          else torch.zeros((B, H, K, K), device=DEV))
    return r, k, v, logw, u, s0


def wkv6_work(B, T, H, in_bytes) -> tuple:
    """(products, elementwise operations, bytes) that the WKV6 function needs
    on these shapes.

    Bytes: r, k, v, logw and u read once, out written once, state0 read and
    the final state written once. Operations, per (token, head), K = V, by the
    recurrence itself: the products r_t.S and k_t v_t^T, 2 K^2 each, which
    the chunked form does as matrix products; elementwise, the decay of S
    (K^2), the bonus (r_t.(u k_t)) v_t (3 K + 2 K) and K exps, each exp one
    operation.
    """
    K = rk.HEAD_SIZE
    n = B * T * H
    nbytes = n * K * (3 * in_bytes + 4 + 4) + H * K * 4 + 2 * B * H * K * K * 4
    return n * 4 * K * K, n * (K * K + 6 * K), nbytes


def wkv6_chunked_ops(B, T, H) -> int:
    """Operations of the kernel's chunked algorithm, per chunk of n valid rows
    and head: the pairwise scores 7 K per pair s < t (difference, exp, two
    multiplies and an add; then 2 a value column for scores.v), 10 K a row for
    the bonus and the two decays, 4 K^2 a row for the two products with the
    state, 2 K^2 + K for the state's decay. A figure of the algorithm, not the
    bound: it does about 1.5 times what the function needs."""
    K = rk.HEAD_SIZE
    ops_ = 0
    for t0 in range(0, T, rk.CHUNK):
        n = min(rk.CHUNK, T - t0)
        ops_ += n * (n - 1) // 2 * K * 7 + n * K * 10 + n * K * K * 4 + 2 * K * K + K
    return ops_ * B * H


def wkv6_bound(B, T, H, in_bytes) -> dict:
    """The least time on any of the card's units: the bytes at the memory
    rate, the products at the tensor cores' bf16 rate, the elementwise work
    at the CUDA cores' f32 rate. Beside it, under its own name, the figure
    that counts every operation at the CUDA cores' rate (the bound of a kernel
    that keeps the products off the tensor cores)."""
    prods, elem, nbytes = wkv6_work(B, T, H, in_bytes)
    t_prods, t_elem = prods / PEAK_BF16_FLOPS * 1e3, elem / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(t_prods, t_elem)
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_reckoned": f"max({nbytes:.4g} B / 3.35 TB/s, {prods:.4g} product FLOP / 989 TFLOP/s, "
                              f"{elem:.4g} elementwise operations / 67 TFLOP/s)",
            "cuda_core_bound_ms": max((prods + elem) / PEAK_F32_FLOPS * 1e3, t_bytes),
            "cuda_core_bound_reckoned": f"max({prods + elem:.4g} operations / 67 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)",
            "chunked_algorithm_ops": wkv6_chunked_ops(B, T, H)}


def wkv6_resources(bh: int) -> dict:
    """Registers and spills (ptxas, where this process compiled the kernel)
    and blocks an SM of each instantiation of K5, and the V split that
    ``bh`` (batch x heads) blocks take."""
    kernels = ptxas_by_kernel(_build.ptxas_log.get("wkv6_scan", ""))
    occ = {k: v for k, v in occupancy().items() if k.startswith("wkv6_kernel<")}
    return {"kernels": {k: {**kernels.get(k, {}), **v} for k, v in occ.items()},
            "v_splits": rk.n_splits(bh, 1, _build.sm_count(0))}


def wkv6_case(gen, B, T, H, dtype=torch.bfloat16, **kw) -> dict:
    """The WKV6 kernel (out and final state) against its plain version, run in
    float64 on the same inputs, at one shape. The plain version's own f32 run
    is held against the same float64 run, as context only."""
    args = wkv6_inputs(gen, B, T, H, dtype, **kw)
    launches0 = rk.launch_count
    out, state = rk.wkv6_scan(*args)
    torch.cuda.synchronize()
    require(rk.launch_count == launches0 + 1, "the wkv6 wrapper did not count its launch")
    with full_f32_matmul():
        out_ref, state_ref = ref.wkv6_reference(*args)
        out64, state64 = ref.wkv6_reference(*(x.double() for x in args))
    label = f"wkv6 B{B} T{T} H{H} {dtype} {kw}"
    errs = {"plain_f32_out_max_abs_err": max_err(out_ref, out64),
            "plain_f32_state_max_abs_err": max_err(state_ref, state64),
            "out_rms": out64.square().mean().sqrt().item()}
    del out_ref, state_ref
    for name, got, want in (("out", out, out64), ("state", state, state64)):
        errs[f"{name}_max_abs_err"] = check(f"{label} {name}", got, want, TOL_WKV)
    return {"B": B, "T": T, "H": H, "dtype": str(dtype).replace("torch.", ""), **kw,
            "v_splits": rk.n_splits(B, H, _build.sm_count(0)), **errs}


def phase_wkv6(cfg) -> dict:
    """K5 at the prefill shape of rwkv6-1.6b, at one long sequence and at
    ragged small shapes; the guard against autograd; its times."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    H = cfg.d_model // cfg.ssm.head_dim
    cases = [
        wkv6_case(gen, BATCH, PROMPT, H),                                  # the main path's shape
        wkv6_case(gen, BATCH, PROMPT, H, state=True, decay="model"),      # the model's slow decay
        wkv6_case(gen, 1, WKV_LONG_T, H),                                 # 512 chunks, V split 4 ways
        wkv6_case(gen, 3, 200, H, state=True),                            # ragged, V split 2 ways
        wkv6_case(gen, 2, 100, 4, state=True),                            # ragged
        wkv6_case(gen, 1, 37, 2),                                         # T < 64
        wkv6_case(gen, 1, 192, 2, state=True, decay=-3.0),                # strong decay
        wkv6_case(gen, 2, 256, 4, state=True, decay=-20.0),               # 2^-1850 a chunk: finite, no overflow
        # f32 inputs at the (B, T, H, state) of the reference's WKV_CASES, K = V = 64
        wkv6_case(gen, 1, 64, 2, torch.float32),
        wkv6_case(gen, 2, 128, 4, torch.float32),
        wkv6_case(gen, 1, 96, 2, torch.float32, state=True),
        wkv6_case(gen, 2, 64, 2, torch.float32),
        # rows 65 elements apart, off 16 bytes: the wrapper copies them
        wkv6_case(gen, 2, 100, 4, state=True, width=65),
        wkv6_case(gen, 1, 96, 2, torch.float32, state=True, width=65),
    ]

    # no backward: a call that autograd would differentiate raises on the card
    small = wkv6_inputs(gen, 1, 64, 2, torch.float32)
    small[0].requires_grad_(True)
    launches0 = rk.launch_count
    try:
        ops.wkv6(*small)
        guarded = False
    except NotImplementedError:
        guarded = True
    require(guarded and rk.launch_count == launches0, "ops.wkv6 launched on inputs that need a gradient")
    with torch.no_grad():
        ops.wkv6(*small)
    require(rk.launch_count == launches0 + 1, "ops.wkv6 under no_grad did not launch the kernel")

    # timings at the prefill shape, and at the long one
    args = wkv6_inputs(gen, BATCH, PROMPT, H)
    kernel_ms = gpu_ms(lambda: rk.wkv6_scan(*args), iters=20)
    with full_f32_matmul():
        plain_ms = gpu_ms(lambda: ref.wkv6_reference(*args), iters=1, reps=3)
        chunked_ms = gpu_ms(lambda: rwkv6.wkv_chunked(*args), iters=1, reps=3)
    del args
    long_args = wkv6_inputs(gen, 1, WKV_LONG_T, H)
    long_ms = gpu_ms(lambda: rk.wkv6_scan(*long_args), iters=10)
    with full_f32_matmul():
        long_chunked_ms = gpu_ms(lambda: rwkv6.wkv_chunked(*long_args), iters=1, reps=1)
    del long_args
    torch.cuda.empty_cache()

    main = cases[0]
    bound = wkv6_bound(BATCH, PROMPT, H, 2)
    long_bound = wkv6_bound(1, WKV_LONG_T, H, 2)
    out = {
        "name": "wkv6_scan", "replaces": "src/repro/kernels/rwkv6_scan.py:124",
        "shape": f"r/k/v ({BATCH},{PROMPT},{H},64) bf16, logw f32, state0 0",
        "tolerance": {"out, state": f"atol=rtol={TOL_WKV} against the plain version in float64"},
        "max_abs_err": max(main["out_max_abs_err"], main["state_max_abs_err"]),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "plain_call": "ref.wkv6_reference (token by token)",
        "chunked_ms": chunked_ms, "chunked_call": "models.rwkv6.wkv_chunked (the model's non-kernel path)",
        "library_ms": None, "library_call": "none: no single PyTorch call computes WKV6",
        **bound,
        "achieved_bytes_per_s": wkv6_work(BATCH, PROMPT, H, 2)[2] / (kernel_ms * 1e-3),
        "resources": wkv6_resources(BATCH * H),
        "long": {"shape": f"r/k/v (1,{WKV_LONG_T},{H},64) bf16", "kernel_ms": long_ms,
                 "chunked_ms": long_chunked_ms, **long_bound},
        "cases": cases,
    }
    emit("kernel", **out)
    return out


@contextlib.contextmanager
def torch_wkv_path():
    """Inside the block the rwkv6 prefill's WKV goes to the non-kernel
    ``wkv_chunked``, by rebinding the name ``time_mix_seq`` calls (as
    ``torch_attention_path`` does for attention)."""
    saved = rwkv6.wkv6
    rwkv6.wkv6 = rwkv6.wkv_chunked
    try:
        yield
    finally:
        rwkv6.wkv6 = saved


@contextlib.contextmanager
def wkv_probe():
    """Inside the block the first WKV call of the rwkv6 prefill (layer 0's)
    keeps copies of its inputs and outputs for the first sequence of the
    batch. Yields a function that, after the block, returns (name, got,
    want, plain) for its out and state: ``want`` the plain version in float64
    on the same inputs, ``plain`` its f32 run, as context. So the main path's
    own run holds K5 to float64 on the model's r, k, v and logw, where the
    logits, past 24 layers in bf16, do not resolve a fault that moves the
    scores by a few percent."""
    kept = []
    saved = rwkv6.wkv6

    def first_call(*args, **kw):
        out = saved(*args, **kw)
        if not kept:
            kept.append(tuple(x[:1].clone() for x in (*args[:4], *args[5:6], *out)))
            kept.append(args[4])
        return out

    def compared() -> list:
        require(len(kept) == 2, "the prefill made no WKV call")
        (r, k, v, logw, s0, out, state), u = kept
        with full_f32_matmul():
            out64, state64 = ref.wkv6_reference(*(x.double() for x in (r, k, v, logw, u, s0)))
            out32, state32 = ref.wkv6_reference(r, k, v, logw, u, s0)
        return [("wkv6_layer0_out", out, out64, out32), ("wkv6_layer0_state", state, state64, state32)]

    rwkv6.wkv6 = first_call
    try:
        yield compared
    finally:
        rwkv6.wkv6 = saved


@contextlib.contextmanager
def flash_launches_per_step(record: list, times: list):
    """Inside the block every train step that ``launch.train.run`` builds
    appends its (K1, K2, K3) launch counts to ``record`` and its (host ms,
    device ms) to ``times``: the host clock from the call to the end of its
    work on the device (the launcher waits there anyway, for the loss), the
    device's by CUDA events. Like ``torch_attention_path``, a rebinding made
    by this script only."""
    saved = train_step.build_train_step

    def build(*args, **kwargs):
        step = saved(*args, **kwargs)

        def counted(state, batch):
            before = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
            out, host_ms, device_ms = timed(lambda: step(state, batch))
            after = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
            record.append(tuple(a - b for a, b in zip(after, before)))
            times.append((host_ms, device_ms))
            return out

        return counted

    train_step.build_train_step = build
    try:
        yield
    finally:
        train_step.build_train_step = saved


@contextlib.contextmanager
def train_config(cfg):
    """Inside the block ``launch.train.run`` trains ``cfg`` whatever ``--arch``
    names (the depth-2 resume check); a rebinding made by this script only."""
    saved = train.get_config
    train.get_config = lambda arch: cfg
    try:
        yield
    finally:
        train.get_config = saved


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """||got - want|| / ||want|| in f32: over the whole tensor, and over each
    slice of the leading dim (each layer of a stacked leaf)."""
    g = got.float().reshape(got.shape[0] if got.dim() > 1 else 1, -1)
    w = want.float().reshape(g.shape)
    num, den = (g - w).square().sum(dim=1), w.square().sum(dim=1)
    whole = (num.sum() / den.sum().clamp_min(1e-30)).sqrt().item()
    return whole, (num / den.clamp_min(1e-30)).sqrt().tolist()


def train_args(**overrides):
    argv = ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--warmup", "2", "--log-every", "1", "--device", "cuda"]
    args = train.build_argparser().parse_args(argv)
    for key, val in overrides.items():
        setattr(args, key, val)
    return args


def is_attn_leaf(name: str) -> bool:
    """A parameter of an attention block (its projections), by its path:
    layers/attn/*, enc_layers/attn/*, dec_layers/self_attn/*, dec_layers/cross_attn/*."""
    return any(part in ("attn", "self_attn", "cross_attn") for part in name.split("/"))


def attention_calls(cfg) -> int:
    """Flash attention calls of one forward: one a layer, and for the
    encoder-decoder one an encoder layer and two (self, cross) a decoder layer."""
    return cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers


def one_step(cfg, model, plan, tol=(TOL_LOSS, TOL_GRAD_ATTN, TOL_GRAD_OTHER), batch_size=TRAIN_BATCH,
             seq=TRAIN_SEQ) -> dict:
    """One step's loss and gradients, kernels against the non-kernel path, from
    one seeded init and one batch, no optimizer. Emits its readings before it
    holds them to the limits ``tol`` (loss, attention leaves, other leaves),
    so that a failing run still shows them."""
    tol_loss, tol_attn, tol_other = tol
    L = cfg.n_layers
    n_attn = attention_calls(cfg)
    expected = (2 * n_attn if cfg.remat else n_attn, n_attn, n_attn)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    suite = ShapeSuite("train_4k", seq, batch_size, "train")
    batch = from_jax_params(synthetic.batch_for(cfg, suite, seed=0), DEV)  # whisper's frames are bf16 numpy
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    names = ["/".join(path) for path, _ in tree_paths(params)]

    def loss_and_grads():
        loss, _ = model.loss(params, batch, plan)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    # the MoE family: the non-kernel run routes by the kernel run's choices
    # (its gates its own), as in phase_serve; with remat each layer routes
    # twice a step (forward, and again in backward), in the same order in both runs
    moe_family = cfg.family == "moe"
    routes_k, routes_t = [], []
    fa.launch_count = fa.dkv_launch_count = fa.dq_launch_count = 0
    with routes_recorded(routes_k) if moe_family else contextlib.nullcontext():
        loss_k, grads_k = loss_and_grads()
    launches = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    with torch_attention_path(), (routes_recorded(routes_t, routes_k) if moe_family else contextlib.nullcontext()):
        loss_t, grads_t = loss_and_grads()
    kernel_free = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count) == launches
    finite = [n for n, g in zip(names, grads_k) if not torch.isfinite(g.float()).all()]
    whole, by_layer = {}, {}
    for name, gk, gt in zip(names, grads_k, grads_t):
        whole[name], per = rel_l2(gk, gt)
        if is_attn_leaf(name):
            by_layer[name] = per
    del params, leaves, grads_k, grads_t, batch
    attn = {n: e for n, e in whole.items() if is_attn_leaf(n)}
    other = {n: e for n, e in whole.items() if not is_attn_leaf(n)}
    out = {
        "arch": cfg.name, "layers": L, "batch": batch_size, "seq": seq,
        "loss_kernels": loss_k, "loss_torch_path": loss_t, "loss_abs_err": abs(loss_k - loss_t),
        "loss_tolerance": tol_loss, "launches": launches,
        "grad_rel_l2_attention_max": max(attn.values()), "grad_rel_l2_attention_tolerance": tol_attn,
        "grad_rel_l2_other_max": max(other.values()), "grad_rel_l2_other_tolerance": tol_other,
        "grad_rel_l2": whole,
        "grad_rel_l2_attention_by_layer": {n: [min(per), statistics.median(per), max(per)]
                                           for n, per in by_layer.items()},
        "by_layer_is": "[min, median, max] over the layers",
    }
    if moe_family:
        require(len(routes_k) == len(routes_t) > 0, f"{len(routes_k)}, {len(routes_t)} MoE calls")
        out["routing"] = {
            "top_k_sets_compared": sum(a.shape[0] for a in routes_k),
            "top_k_sets_differing": sum(int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
                                        for a, b in zip(routes_k, routes_t)),
            "non_kernel_run": "its own router's choices counted; routed by the kernel run's"}
    emit("train_one_step", **out)
    require(launches == expected, f"one step launched (K1, K2, K3) = {launches}, expected {expected}")
    require(kernel_free, "the non-kernel run launched a kernel")
    require(not finite, f"non-finite grads of {finite}")
    require(out["loss_abs_err"] <= tol_loss, f"train loss {loss_k} (kernels) vs {loss_t} (torch path)")
    for group, errs, limit in (("attention", attn, tol_attn), ("other", other, tol_other)):
        bad = {n: e for n, e in errs.items() if e > limit}
        require(not bad, f"{group} gradient leaves beyond relative L2 {limit}: {bad}")
    return out


def phase_train(cfg) -> dict:
    """granite-3-2b at full size, batch 2, seq 4096, remat on: (a) ``one_step``,
    (b) TRAIN_STEPS steps through
    ``launch.train.run`` with the flash launches counted per step, (c) resume
    at depth 2 against an uninterrupted run."""
    require(cfg.remat, "the full config trains under remat")
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model = build_model(cfg)
    plan = make_plan(cfg, None)

    one = one_step(cfg, model, plan)
    torch.cuda.empty_cache()

    # ---- (b) the main path: TRAIN_STEPS steps through the launcher
    per_step: list = []
    step_times: list = []
    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = fa.dkv_launch_count = fa.dq_launch_count = 0
    with flash_launches_per_step(per_step, step_times):
        result = train.run(train_args())
    launches = {"flash_attention_fwd": fa.launch_count, "flash_attention_bwd_dkv": fa.dkv_launch_count,
                "flash_attention_bwd_dq": fa.dq_launch_count}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(len(per_step) == TRAIN_STEPS and all(c == (2 * L, L, L) for c in per_step),
            f"per-step (K1, K2, K3) launches {per_step}, expected {(2 * L, L, L)} each")
    require(result["steps"] == TRAIN_STEPS and all(
        np.isfinite(result[k]) for k in ("first_loss", "final_loss", "head_mean_loss", "tail_mean_loss")),
        f"train result {result}")
    torch.cuda.empty_cache()
    n_params = model.param_count()
    pairs = live_pairs(TRAIN_BATCH, H, TRAIN_SEQ, TRAIN_SEQ, True)
    # model FLOPs, remat not counted: 6 N per token, and 12 D per live pair and layer
    # for attention's own products (4 D forward, 8 D backward)
    model_flops = 6 * n_params * tokens + 12 * D * pairs * L
    step_s = result["mean_step_ms"] * 1e-3

    # ---- (c) resume at depth 2 and full width: cut at step 3 and resumed
    cut = TRAIN_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp, train_config(dataclasses.replace(cfg, n_layers=2)):
        kw = dict(total_steps=TRAIN_STEPS, ckpt_every=100)
        full = train.run(train_args(ckpt_dir=f"{tmp}/full", **kw))
        train.run(train_args(steps=cut, ckpt_dir=f"{tmp}/resume", total_steps=TRAIN_STEPS, ckpt_every=cut))
        resumed = train.run(train_args(ckpt_dir=f"{tmp}/resume", **kw))
    require(resumed["steps"] == TRAIN_STEPS - cut, f"resumed run took {resumed['steps']} steps")
    require(abs(resumed["final_loss"] - full["final_loss"]) <= TOL_RESUME * abs(full["final_loss"]),
            f"resumed final loss {resumed['final_loss']} vs uninterrupted {full['final_loss']}")

    out = {
        "arch": cfg.name, "layers": L, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
        "params": n_params,
        "one_step": {k: one[k] for k in ("loss_abs_err", "grad_rel_l2_attention_max", "grad_rel_l2_other_max")},
        "steps": result["steps"], "losses": {k: result[k] for k in ("first_loss", "final_loss", "head_mean_loss",
                                                                      "tail_mean_loss")},
        "mean_step_ms": result["mean_step_ms"],
        # over the steps the launcher's mean takes (the first three are warm-up)
        "median_step_ms": statistics.median(t[0] for t in step_times[3:]),
        "median_step_device_ms": statistics.median(t[1] for t in step_times[3:]),
        "step_ms_runs": [t[0] for t in step_times], "step_device_ms_runs": [t[1] for t in step_times],
        "wall_s": result["wall_s"],
        "tokens_per_s": tokens / step_s, "peak_memory_gb": peak_gb,
        "model_flops_per_step": model_flops, "model_flop_share_of_bf16_peak": model_flops / step_s / PEAK_BF16_FLOPS,
        "launches": launches, "launches_per_step": per_step[0],
        "pipeline": result["pipeline"],
        "resume_depth2": {"uninterrupted_final_loss": full["final_loss"], "resumed_final_loss": resumed["final_loss"],
                          "rtol": TOL_RESUME, "mean_step_ms": full["mean_step_ms"]},
    }
    emit("train", **out)
    return out


def timed(fn):
    """(fn(), host ms, device ms): the host clock from the call to the end of
    its work on the device (a synchronize), and CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def prefill_call(model, params, plan, batch):
    """The timed prefill of ``serve``: prefill of ``batch`` (the prompts'
    tokens, and whisper's frames), then the cache padded for NEW tokens."""
    def prefill():
        last, cache = model.prefill(params, batch, plan)
        return last, pad_cache(cache, NEW)
    return prefill


@torch.no_grad()
def serve(model, params, plan, batch, forced_tokens=None):
    """Prefill, pad the cache, NEW - 1 decode steps. Returns the last logits of
    prefill and of every decode step, the tokens fed, the cache's shapes and
    times: the prefill's by the host clock and by CUDA events (``timed``);
    each decode step's by the host clock (between the ends of successive
    steps' calls, no synchronize between steps) and by CUDA events recorded
    after each step (idle time of the device included).

    With ``forced_tokens`` the decode steps are fed those tokens instead of
    their own argmax, so two runs see the same inputs at every step.
    """
    S = batch["tokens"].shape[1]
    (last, cache), prefill_ms, prefill_device_ms = timed(prefill_call(model, params, plan, batch))
    logits = [last]
    tokens = [torch.argmax(last, dim=-1).to(torch.int32)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(NEW)]
    t1 = time.perf_counter()
    host = [t1]
    marks[0].record()
    for i in range(NEW - 1):
        tok = tokens[-1] if forced_tokens is None else forced_tokens[:, i]
        lg, cache = model.decode(params, {"token": tok}, cache, S + i, plan)
        logits.append(lg)
        tokens.append(torch.argmax(lg, dim=-1).to(torch.int32))
        marks[i + 1].record()
        host.append(time.perf_counter())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {
        "logits": torch.stack(logits, dim=1),  # (B, NEW, V)
        "tokens": torch.stack(tokens, dim=1),  # (B, NEW)
        "cache_shapes": {name: tuple(leaf.shape) for name, leaf in cache.items()},
        "prefill_ms": prefill_ms,
        "prefill_device_ms": prefill_device_ms,
        "decode_ms_per_step": (t2 - t1) * 1e3 / (NEW - 1),
        "decode_step_ms_median": statistics.median((b - a) * 1e3 for a, b in zip(host, host[1:])),
        "decode_step_device_ms_median": statistics.median(a.elapsed_time(b) for a, b in zip(marks, marks[1:])),
    }


@contextlib.contextmanager
def routes_recorded(record: list, replay=None):
    """Inside the block every MoE layer call appends its top-k expert ids to
    ``record``. With ``replay`` (the ids another run recorded, one entry a
    layer call, in the same order) each call still records its own choice but
    routes by the replayed one, its gates the call's own probabilities at
    those experts, renormalized as ``top_k_gates`` does. A rebinding made by
    this script only, as ``torch_attention_path`` is."""
    saved = moe.top_k_gates
    replayed = iter(replay) if replay is not None else None

    def recording(probs, k, renormalize=True):
        vals, idx = saved(probs, k, renormalize)
        record.append(idx)
        if replayed is None:
            return vals, idx
        forced = next(replayed)
        vals = torch.gather(probs, -1, forced)
        if renormalize:
            vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return vals, forced

    moe.top_k_gates = recording
    try:
        yield
    finally:
        moe.top_k_gates = saved


@contextlib.contextmanager
def attention_timed(times: dict):
    """Inside the block every attention call of the model (``flash_attention``
    and ``decode_attention`` as the transformer and the families built on it
    call them) is bracketed by CUDA events; after a synchronize,
    ``times[name]`` sums their device ms. A rebinding made by this script only."""
    pairs = {"flash_attention_fwd": [], "decode_attention": []}

    def bracketed(name, fn):
        def call(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            pairs[name].append((start, end))
            return out
        return call

    with attention_rebound(bracketed("flash_attention_fwd", transformer.flash_attention),
                           bracketed("decode_attention", transformer.decode_attention)):
        yield
    torch.cuda.synchronize()
    for name, ps in pairs.items():
        times[name] = sum(a.elapsed_time(b) for a, b in ps)
        times[name + "_calls"] = len(ps)


def rows_within(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``check_rows``'s test, counted instead of raised: (elements beyond
    TOL_ROW_RMS * rms(row) + 1 ulp, the largest |got - want| / allowance,
    max abs err)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    allowed = TOL_ROW_RMS * w.square().mean(dim=-1, keepdim=True).sqrt() + ULP[got.dtype] * w.abs()
    return (int((diff > allowed).sum()) + int((~torch.isfinite(g)).sum()),
            (diff / allowed.clamp_min(1e-30)).max().item(), diff.max().item())


@contextlib.contextmanager
def attention_probed(records: dict):
    """Inside the block every attention call of the model runs as it would
    (through the kernels) and, beside it, the kernel's plain version on the
    same inputs (``kernels/ref.py``, f32); ``records[name]`` collects
    ``rows_within`` of each call: each launch of K1 and K4 held, on the
    model's own inputs, to the tolerance its phase holds it to at this shape.
    A rebinding made by this script only."""
    saved = transformer.flash_attention, transformer.decode_attention
    for name in ("flash_attention_fwd", "decode_attention"):
        records.setdefault(name, [])

    def flash(q, k, v, *, causal=True, block_k=1024, q_offset=0, scale=None, kv_len=None):
        out = saved[0](q, k, v, causal=causal, block_k=block_k, q_offset=q_offset, scale=scale, kv_len=kv_len)
        want = ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
        records["flash_attention_fwd"].append(rows_within(out, want))
        return out

    def decode(q, k_cache, v_cache, *, kv_len, scale=None):
        out = saved[1](q, k_cache, v_cache, kv_len=kv_len, scale=scale)
        want = ref.decode_attention_reference(q[:, 0], k_cache, v_cache, kv_len=kv_len, scale=scale)[:, None]
        records["decode_attention"].append(rows_within(out, want))
        return out

    with attention_rebound(flash, decode):
        yield


def phase_serve(cfg, counters: dict, expected: dict, torch_path, cache_shapes: dict, probe=None,
                prompt: int = PROMPT, yardstick=None) -> dict:
    """Serve ``cfg`` at full size (batch 8, a prompt of ``prompt`` tokens, 32
    new tokens; whisper's batch also holds its frames), random weights from a
    seed, through the kernels; then the same requests on the non-kernel path
    (inside ``torch_path``), fed the same tokens.

    ``counters`` names the kernel wrappers whose ``launch_count`` the run must
    raise by ``expected[name]`` (set to 0 just before the run, read just
    after); the non-kernel run must raise none. ``probe``, if given, is a
    context manager around the run (as ``wkv_probe``) that yields a function
    returning (name, got, want, plain) tuples: each ``got`` is held to
    ``want`` as TOL_WKV_SERVED_* say, ``plain``'s distance reported beside.
    For the MoE family both runs record their routing, and the (layer call,
    token) top-k sets on which they differ are counted; the non-kernel run
    routes by the kernel run's choices (``routes_recorded``'s replay), its
    gates its own. Routing is discontinuous: the two paths' hidden states
    differ by bf16 roundings, a near-tie of two router probabilities flips
    with them, and a token sent to another expert moves its logits by O(1),
    which would say nothing of the kernels. After both runs, one
    more serve through the kernels brackets every attention call with CUDA
    events: K1's share of the prefill's device time and K4's of the decode
    steps'. And one more serves again with every attention call held to its
    kernel's plain version on the same inputs (``attention_probed``).

    With ``yardstick`` (a context manager like ``torch_path``: a second
    non-kernel path, ``f32_attention_path``) the logits are not held to
    granite's limits but to that path's own distance from ``torch_path``:
    a third run, fed the same tokens (and routed by the kernel run's choices),
    and the kernel run's relative L2 distance from the non-kernel run's
    logits, over that third run's, must stay within SPREAD_LIMIT, for the
    prefill's and for the decode steps' logits each. This is for a model
    whose roundings the depth amplifies past granite's limits whatever
    computes its attention (deepseek-moe-16b at the reference's init).
    """
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    extras = {"frames": ((BATCH, cfg.n_frames, cfg.d_model), "bfloat16")} if cfg.enc_layers else {}
    batch = from_jax_params(synthetic.token_batch(cfg.vocab, BATCH, prompt, seed=7, extras=extras), DEV)
    batch.pop("labels")

    # warm-up (library handles, allocator), at full size: not counted
    with torch.no_grad():
        _, c = prefill_call(model, params, plan, batch)()
        model.decode(params, {"token": batch["tokens"][:, 0]}, c, prompt, plan)
        del c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # prefills timed as the main path's own, for the medians beside it
    with torch.no_grad():
        extra = [timed(prefill_call(model, params, plan, batch))[1:] for _ in range(PREFILLS - 1)]

    routes_k, routes_t = [], []
    moe_family = cfg.family == "moe"
    # ---- the main path, through the kernels, with the counts set to 0 just before
    for mod in counters.values():
        mod.launch_count = 0
    with (probe() if probe else contextlib.nullcontext(list)) as probed, \
            (routes_recorded(routes_k) if moe_family else contextlib.nullcontext()):
        run = serve(model, params, plan, batch)
    launches = {name: mod.launch_count for name, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_vs_float64 = probed()

    require(launches == expected, f"launches {launches}, expected {expected}")
    require(run["logits"].shape == (BATCH, NEW, cfg.padded_vocab), f"logits shape {tuple(run['logits'].shape)}")
    require(run["cache_shapes"] == cache_shapes, f"cache shapes {run['cache_shapes']}, expected {cache_shapes}")
    require(torch.isfinite(run["logits"][..., : cfg.vocab].float()).all(), "non-finite logits")
    require((run["tokens"] >= 0).all() and (run["tokens"] < cfg.vocab).all(), "a greedy token outside the vocab")

    # ---- the same requests on the non-kernel PyTorch path, fed the same tokens
    with torch_path(), (routes_recorded(routes_t, routes_k) if moe_family else contextlib.nullcontext()):
        base = serve(model, params, plan, batch, forced_tokens=run["tokens"])
    require({name: mod.launch_count for name, mod in counters.items()} == launches,
            "the non-kernel run launched a kernel")
    got = run["logits"][..., : cfg.vocab]
    want = base["logits"][..., : cfg.vocab]
    beyond = int(((got.float() - want.float()).abs() > TOL_LOGITS + TOL_LOGITS * want.float().abs()).sum())
    agree = (run["tokens"] == base["tokens"]).float().mean().item()

    spread = {}
    if yardstick is not None:
        routes_y: list = []
        with yardstick(), (routes_recorded(routes_y, routes_k) if moe_family else contextlib.nullcontext()):
            alt = serve(model, params, plan, batch, forced_tokens=run["tokens"])
        require({name: mod.launch_count for name, mod in counters.items()} == launches,
                "the yardstick run launched a kernel")
        alt_logits = alt["logits"][..., : cfg.vocab]
        for part, sl in (("prefill", slice(0, 1)), ("decode", slice(1, None))):
            w = want[:, sl].float()
            r_k = ((got[:, sl].float() - w).norm() / w.norm()).item()
            r_y = ((alt_logits[:, sl].float() - w).norm() / w.norm()).item()
            spread[part] = {"kernel_vs_torch_path_rel_l2": r_k, "yardstick_vs_torch_path_rel_l2": r_y,
                            "ratio": r_k / r_y if r_y else (0.0 if r_k == 0 else float("inf")),
                            "kernel_beyond_tolerance": n_beyond(got[:, sl], want[:, sl], TOL_LOGITS),
                            "yardstick_beyond_tolerance": n_beyond(alt_logits[:, sl], want[:, sl], TOL_LOGITS),
                            "compared": w.numel()}
        del alt, alt_logits

    # ---- attention's share of the device time, on one more run through the kernels
    attn: dict = {}
    with torch.no_grad():
        with attention_timed(attn):
            (_, c), _, share_prefill_ms = timed(prefill_call(model, params, plan, batch))
        prefill_attn = dict(attn)
        tok = run["tokens"]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with attention_timed(attn):
            start.record()
            for i in range(NEW - 1):
                model.decode(params, {"token": tok[:, i]}, c, prompt + i, plan)
            end.record()
        end.synchronize()
        decode_device_ms = start.elapsed_time(end)
        del c
    # ---- every attention call of one more run held to its plain version on its own inputs
    probed: dict = {}
    with torch.no_grad():
        with attention_probed(probed):
            _, c = prefill_call(model, params, plan, batch)()
            for i in range(NEW - 1):
                model.decode(params, {"token": tok[:, i]}, c, prompt + i, plan)
        del c
    attention_calls = {
        name: {"calls": len(recs), "elements_beyond": sum(r[0] for r in recs),
               "worst_err_over_allowed": max((r[1] for r in recs), default=0.0),
               "max_abs_err": max((r[2] for r in recs), default=0.0)}
        for name, recs in probed.items()}
    attention_calls["tolerance"] = f"{TOL_ROW_RMS} * rms(row) + 1 ulp, against kernels/ref.py in f32"
    attention_share = {
        "prefill_device_ms": share_prefill_ms,
        "flash_attention_fwd_ms": prefill_attn["flash_attention_fwd"],
        "flash_attention_fwd_calls": prefill_attn["flash_attention_fwd_calls"],
        "flash_attention_fwd_share_of_prefill": prefill_attn["flash_attention_fwd"] / share_prefill_ms,
        "decode_device_ms": decode_device_ms, "decode_attention_ms": attn["decode_attention"],
        "decode_attention_calls": attn["decode_attention_calls"],
        "decode_attention_share_of_decode": attn["decode_attention"] / decode_device_ms,
        "reckoned": "CUDA events around each attention call (its wrapper and kernel) summed, over the device "
                    "time of the prefill and of the NEW - 1 decode steps, on a run after the main path's",
    }

    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "batch": BATCH, "prompt": prompt,
        "new_tokens": NEW, "params": param_count(params), "param_gb": param_bytes(params) / 1e9,
        "prefill_ms": run["prefill_ms"], "decode_ms_per_step": run["decode_ms_per_step"],
        "prefill_ms_median": statistics.median([e[0] for e in extra] + [run["prefill_ms"]]),
        "prefill_device_ms_median": statistics.median([e[1] for e in extra] + [run["prefill_device_ms"]]),
        "prefill_ms_runs": [e[0] for e in extra] + [run["prefill_ms"]],
        "prefill_device_ms_runs": [e[1] for e in extra] + [run["prefill_device_ms"]],
        "decode_step_ms_median": run["decode_step_ms_median"],
        "decode_step_device_ms_median": run["decode_step_device_ms_median"],
        "prefill_tokens_per_s": BATCH * prompt / (run["prefill_ms"] * 1e-3),
        "decode_tokens_per_s": BATCH / (run["decode_ms_per_step"] * 1e-3),
        "peak_memory_gb": peak_gb,
        "launches": launches,
        "torch_path": {"prefill_ms": base["prefill_ms"], "decode_ms_per_step": base["decode_ms_per_step"]},
        "logits_tolerance": {"atol=rtol": TOL_LOGITS, "share_allowed_beyond": TOL_LOGITS_OUTLIERS,
                             "hard_limit": TOL_LOGITS_HARD},
        "logits_beyond_tolerance": beyond, "logits_compared": got.numel(),
        "logits_abs_max": want.float().abs().max().item(), "logits_std": want.float().std().item(),
        "logits_max_abs_err": max_err(got, want), "greedy_token_agreement": agree,
        "attention_share": attention_share,
        "attention_calls_vs_plain": attention_calls,
    }
    if spread:
        out["yardstick"] = dict(spread, path="f32 plain attention (kernels/ref.py), routed by the kernel run's "
                                              "choices", limit=SPREAD_LIMIT)
    if moe_family:
        require(len(routes_k) == len(routes_t) == cfg.n_layers * NEW, f"{len(routes_k)}, {len(routes_t)} MoE calls")
        differ = [int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
                  for a, b in zip(routes_k, routes_t)]
        out["routing"] = {"top_k_sets_compared": sum(a.shape[0] for a in routes_k),
                          "top_k_sets_differing": sum(differ),
                          "prefill_top_k_sets_differing": sum(differ[: cfg.n_layers]),
                          "layer_calls_with_a_difference": sum(d > 0 for d in differ),
                          "non_kernel_run": "its own router's choices counted; routed by the kernel run's"}
    for name, g, w, plain in kernel_vs_float64:
        out[name] = {"max_abs_err": max_err(g, w), "beyond_tolerance": n_beyond(g, w, TOL_WKV),
                     "compared": g.numel(), "rms": w.square().mean().sqrt().item(),
                     "plain_f32_max_abs_err": max_err(plain, w), "plain_f32_beyond_tolerance": n_beyond(plain, w, TOL_WKV),
                     "tolerance": {"atol=rtol": TOL_WKV, "share_allowed_beyond": TOL_WKV_SERVED_OUTLIERS,
                                   "hard_limit": TOL_WKV_SERVED_HARD}}
    emit("serve", **out)  # the readings first, so that a failing run still shows them
    for name, g, w, _ in kernel_vs_float64:
        check(f"serve {cfg.name}: {name}, kernel on the run's own inputs vs float64", g, w, TOL_WKV,
              TOL_WKV_SERVED_OUTLIERS, TOL_WKV_SERVED_HARD)
    for name in ("flash_attention_fwd", "decode_attention"):
        a = attention_calls[name]
        require(a["calls"] == attention_share[name + "_calls"] and not a["elements_beyond"],
                f"serve {cfg.name}: {name} on the model's own inputs: {a}")
    if spread:
        for part, r in spread.items():
            require(r["ratio"] <= SPREAD_LIMIT,
                    f"serve {cfg.name}: {part} logits {r['kernel_vs_torch_path_rel_l2']} from the torch path, "
                    f"{r['ratio']} times the yardstick's {r['yardstick_vs_torch_path_rel_l2']} (limit {SPREAD_LIMIT})")
        return out
    out["prefill_logits_max_abs_err"] = check(
        f"serve {cfg.name}: prefill last logits, kernels vs torch path", got[:, 0], want[:, 0],
        TOL_LOGITS, TOL_LOGITS_OUTLIERS, TOL_LOGITS_HARD)
    out["decode_logits_max_abs_err"] = check(
        f"serve {cfg.name}: decode logits, kernels vs torch path", got[:, 1:], want[:, 1:],
        TOL_LOGITS, TOL_LOGITS_OUTLIERS, TOL_LOGITS_HARD)
    return out


@contextlib.contextmanager
def step_times(times: list):
    """Inside the block every train step that ``launch.train.run`` builds
    appends its (host ms, device ms) to ``times`` (as ``timed`` takes them);
    a rebinding made by this script only."""
    saved = train_step.build_train_step

    def build(*args, **kwargs):
        step = saved(*args, **kwargs)

        def clocked(state, batch):
            out, host_ms, device_ms = timed(lambda: step(state, batch))
            times.append((host_ms, device_ms))
            return out

        return clocked

    train_step.build_train_step = build
    try:
        yield
    finally:
        train_step.build_train_step = saved


@contextlib.contextmanager
def symmetric_padding():
    """Inside the block the ResNet pads every window symmetrically, k // 2 a
    side, as PyTorch's ``padding=k // 2`` would: the same shapes as XLA's
    "SAME", other windows where its total padding is odd. The planted fault
    of the card-vs-float64 check; a rebinding made by this script only."""
    saved = resnet.same_pads
    resnet.same_pads = lambda size, k, stride: (k // 2, k // 2)
    try:
        yield
    finally:
        resnet.same_pads = saved


@contextlib.contextmanager
def nchw_convolutions():
    """Inside the block every ResNet convolution takes an NCHW-contiguous copy
    of its input and weight (the explicit permute) instead of the
    channels_last views; timing only, a rebinding made by this script only."""
    saved = resnet.conv_apply

    def conv_apply(p, x, stride=1):
        w = p["w"].to(x.dtype)
        k = w.shape[0]
        (hl, hh), (wl, wh) = resnet.same_pads(x.shape[1], k, stride), resnet.same_pads(x.shape[2], k, stride)
        y = F.conv2d(F.pad(x, (0, 0, wl, wh, hl, hh)).permute(0, 3, 1, 2).contiguous(),
                     w.permute(3, 2, 0, 1).contiguous(), stride=stride)
        return y.permute(0, 2, 3, 1)

    resnet.conv_apply = conv_apply
    try:
        yield
    finally:
        resnet.conv_apply = saved


def resnet_batch(cfg, device) -> dict:
    suite = ShapeSuite("paper", cfg.img_size**2, RESNET_BATCH, "train")
    return {k: torch.from_numpy(v).to(device) for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}


def resnet_grads(model, params, batch) -> tuple:
    """(loss, grads) of one step, no optimizer, in the parameters' type."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch, None)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def resnet_vs_float64(arch) -> dict:
    """One step of ``arch`` at full size and batch RESNET_BATCH on the card (f32,
    TF32 off, as the launcher runs it), sound and with symmetric padding
    planted, against the same step on the CPU in float64: the loss's
    relative error and the largest relative L2 error of a gradient leaf."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    batch = resnet_batch(cfg, DEV)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        sound = resnet_grads(model, params, batch)
        with symmetric_padding():
            planted = resnet_grads(model, params, batch)
    params64 = tree_map(lambda x: x.detach().cpu().double(), params)
    batch64 = {"images": batch["images"].cpu().double(), "labels": batch["labels"].cpu()}
    want = resnet_grads(model, params64, batch64)
    names = ["/".join(path) for path, _ in tree_paths(params)]
    out = {"arch": arch, "batch": RESNET_BATCH}
    for name, (loss, grads) in (("sound", sound), ("planted_symmetric_padding", planted)):
        errs = {n: rel_l2(g.cpu(), w)[0] for n, g, w in zip(names, grads, want[1])}
        worst = max(errs, key=errs.get)
        out[name] = {
            "loss": loss.item(), "loss_float64": want[0].item(),
            "loss_rel_err": abs(loss.item() - want[0].item()) / abs(want[0].item()),
            "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst_leaf": worst,
            "grad_rel_l2_median": statistics.median(errs.values()),
        }
    return out


def resnet_train(arch) -> dict:
    """RESNET_STEPS steps of ``arch`` at full size and batch RESNET_BATCH
    through ``launch.train.run``; the step by both clocks after the
    launcher's warm-up, images/s, peak memory, the reckoned epoch, and the
    FLOPs of one step (forward and backward) by FlopCounterMode."""
    cfg = get_config(arch)
    times: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--steps", str(RESNET_STEPS), "--batch", str(RESNET_BATCH), "--warmup", "2",
            "--log-every", str(RESNET_STEPS), "--device", "cuda"]
    with step_times(times):
        result = train.run(train.build_argparser().parse_args(argv))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(result["steps"] == RESNET_STEPS and len(times) == RESNET_STEPS, f"{arch}: {result}")
    require(all(np.isfinite(result[k]) for k in ("first_loss", "final_loss")), f"{arch}: non-finite loss {result}")

    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), DEV)
    batch = resnet_batch(cfg, DEV)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False, allow_tf32=False):
        with FlopCounterMode(display=False) as counter:
            resnet_grads(model, params, batch)
        step_flops = counter.get_total_flops()
        # the convolutions' layout: channels_last views against NCHW copies, one step each
        layout_ms = {"channels_last_views": gpu_ms(lambda: resnet_grads(model, params, batch), iters=3, reps=3)}
        with nchw_convolutions():
            layout_ms["nchw_copies"] = gpu_ms(lambda: resnet_grads(model, params, batch), iters=3, reps=3)
    del params, batch
    warm = times[3:]  # the launcher's mean leaves out the first three steps too
    step_ms = statistics.median(t[0] for t in warm)
    samples = RESNET_EPOCH_SAMPLES[arch]
    return {
        "arch": arch, "image_size": cfg.img_size, "batch": RESNET_BATCH, "steps": result["steps"],
        "params": model.param_count(),
        "losses": {k: result[k] for k in ("first_loss", "final_loss")},
        "median_step_ms": step_ms, "median_step_device_ms": statistics.median(t[1] for t in warm),
        "mean_step_ms": result["mean_step_ms"],
        "step_ms_runs": [t[0] for t in times], "step_device_ms_runs": [t[1] for t in times],
        "images_per_s": RESNET_BATCH / (step_ms * 1e-3), "peak_memory_gb": peak_gb,
        "epoch_samples": samples,
        "epoch_s_reckoned": -(-samples // RESNET_BATCH) * step_ms * 1e-3,
        "epoch_reckoned": "ceil(samples / batch) x median step (repro/core/metrics.py::epoch_time_s)",
        "flops_per_step": step_flops,
        "flop_share_of_f32_peak": step_flops / (step_ms * 1e-3) / PEAK_F32_FLOPS,
        "precision": "f32 convolutions (cuDNN TF32 off), f32 head",
        "fwd_bwd_ms_by_conv_layout": layout_ms,
        "pipeline": result["pipeline"],
    }


def phase_resnet() -> dict:
    """The paper's trio at full size and batch 32 through the launcher, then
    the card-vs-float64 step check of resnet_small and resnet_medium with its
    planted fault. Emits its readings before it holds them to the limits."""
    runs = [resnet_train(arch) for arch in RESNET_ARCHS]
    for run in runs:
        emit("resnet_train", **run)
    torch.cuda.empty_cache()
    checks = [resnet_vs_float64(arch) for arch in ("resnet_small", "resnet_medium")]
    limits = {"loss_rel_err": TOL_RESNET_LOSS, "grad_rel_l2_max": TOL_RESNET_GRAD}
    emit("resnet_vs_float64", limits=limits, checks=checks)
    for c in checks:
        sound, planted = c["sound"], c["planted_symmetric_padding"]
        require(all(sound[k] <= v for k, v in limits.items()),
                f"{c['arch']}: the card's step against float64 {sound}, limits {limits}")
        require(any(planted[k] > v for k, v in limits.items()),
                f"{c['arch']}: symmetric padding planted passed the limits {limits}: {planted}")
    return {"runs": runs, "checks": checks}


def characterize(resnet_runs: list) -> dict:
    """``python -m repro_torch.launch.collocate`` for the trio, in a process
    of its own, into a temporary directory. Holds every cell to OK, each solo
    step to SOLO_LIMIT of phase_resnet's median, each record's budget to the
    card's memory and the profile's share of it, and each peak and ``fits``
    to readings taken apart from the command: ``measure_job`` of the same job
    in this process, which tuned the trio's shapes in phase_resnet (the peak
    within PEAK_LIMIT, and ``fits`` as that peak against the budget), and
    phase_resnet's own peak, which holds cuDNN's trials and the launcher's
    batches besides (at least as large)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "repro_torch.launch.collocate", "--workloads", ",".join(RESNET_ARCHS),
                "--out", tmp, "--device", "cuda"]
        cli = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=COLLOCATE_TIMEOUT_S)
        cli_s = time.perf_counter() - t0
        require(cli.returncode == 0, f"collocate exited {cli.returncode}: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
        summary = json.loads((Path(tmp) / "_summary.json").read_text())
        cells = [json.loads(f.read_text()) for f in sorted(Path(tmp).glob("*.json")) if not f.name.startswith("_")]
    sku = get_sku(collocate.SKU)
    total = torch.cuda.get_device_properties(DEV).total_memory
    for c in cells:
        r = c["records"]
        emit("collocate_cell", workload=c["workload"], group=c["group"], mode=c["mode"], status=c["status"],
             instances=len(r), step_s=r[0]["step_s"], fits=all(x["fits"] for x in r),
             peak_bytes=r[0]["peak_bytes_per_device"], hbm_budget_bytes=r[0]["hbm_budget_bytes"],
             measured=c["measured"])
    require(summary["failures"] == 0, f"collocate summary {summary}")
    require(all(c["status"] == "OK" and c["measured"] for c in cells), "a cell is not OK or measured nothing")
    by = {(c["workload"], c["group"]): c for c in cells}
    run_of = {run["arch"]: run for run in resnet_runs}
    peak_here = {}
    for arch in RESNET_ARCHS:
        suite, _ = collocate.PAPER_SUITES[arch]
        peak_here[arch] = measure_job(JobSpec(f"{arch}#0", arch, suite), get_config(arch), DEV).peak_bytes
    solos = {}
    for arch in RESNET_ARCHS:
        solo = by[(arch, "non-MIG")]["records"][0]
        busy = max(solo["compute_s"], solo["memory_s"], solo["collective_s"])
        unfit = sorted({c["group"].split()[0] for c in cells
                        if c["workload"] == arch and c["mode"] == "mig" and not c["records"][0]["fits"]})
        solos[arch] = {
            "step_ms": solo["step_s"] * 1e3, "roofline_step_ms": busy * 1e3, "bound": solo["bound"],
            "measured_over_roofline": solo["step_s"] / busy, "compute_ms": solo["compute_s"] * 1e3,
            "memory_ms": solo["memory_s"] * 1e3, "peak_bytes": solo["peak_bytes_per_device"],
            "peak_bytes_in_this_process": peak_here[arch],
            "phase_resnet_peak_bytes": run_of[arch]["peak_memory_gb"] * 1e9,
            "phase_resnet_median_ms": run_of[arch]["median_step_ms"], "mig_profiles_not_fitting": unfit,
            "collocation_speedup_1g10gb_parallel_vs_7g80gb": (
                7 * by[(arch, f"{sku.full_profile} one")]["records"][0]["step_s"]
                / max(x["step_s"] for x in by[(arch, "1g.10gb parallel")]["records"])),
        }
    emit("collocate_solo", card_memory_bytes=total, solos=solos, command_s=cli_s, wall_s=time.perf_counter() - t0,
         reckoned="measured_over_roofline = measured solo step / max(compute_s, memory_s, collective_s) "
                  "on the card's peaks (f32 67 TFLOP/s, 3.35 TB/s); bytes are telemetry/counts.py's upper bound")
    for arch, s in solos.items():
        ratio = s["step_ms"] / s["phase_resnet_median_ms"]
        require(1 / SOLO_LIMIT <= ratio <= SOLO_LIMIT,
                f"{arch}: solo step {s['step_ms']:.2f} ms against phase_resnet's {s['phase_resnet_median_ms']:.2f}")
        require(1 / PEAK_LIMIT <= s["peak_bytes"] / s["peak_bytes_in_this_process"] <= PEAK_LIMIT
                and s["peak_bytes"] <= s["phase_resnet_peak_bytes"],
                f"{arch}: the command's peak {s['peak_bytes']} against {s['peak_bytes_in_this_process']} in this "
                f"process and phase_resnet's {s['phase_resnet_peak_bytes']}")
    for c in cells:
        for r in c["records"]:
            units = sku.profile(r["profile"]).mem_units
            if c["mode"] in ("naive", "mps"):
                k = len(c["records"])
                budget, need = total, k * peak_here[c["workload"]]
            else:
                budget, need = total * units // sku.n_units, peak_here[c["workload"]]
            require(r["peak_bytes_per_device"] > 0 and r["hbm_budget_bytes"] == budget and r["fits"] == (need <= budget),
                    f"{c['workload']} {c['group']}: fits {r['fits']} with budget {r['hbm_budget_bytes']} "
                    f"(expected {budget}); this process's reading needs {need}")
    return {"cells": by, "solos": solos}


def _read_lines(proc, log: list) -> None:
    for line in proc.stdout:
        log.append((time.perf_counter(), line))


def naive_run(k: int) -> dict:
    """k processes of NAIVE_ARCH training together on the card (the paper's
    naive collocation: no MPS daemon, the GPU time-slices their contexts),
    NAIVE_STEPS steps each through ``launch/train.py`` once all k are warm
    (NAIVE_CHILD). The parent stamps each process's step lines as they
    arrive; the steady window runs from the moment every process is past
    NAIVE_SKIP steps to the moment the first one ends. Returns the aggregate
    images/s in that window and each process's median step in it."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    procs, logs, readers = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        start = Path(tmp) / "start"
        try:
            for i in range(k):
                argv = [sys.executable, "-c", NAIVE_CHILD, str(start), "--arch", NAIVE_ARCH,
                        "--steps", str(NAIVE_STEPS), "--batch", str(RESNET_BATCH), "--warmup", "2",
                        "--log-every", "1", "--seed", str(i), "--metrics-out", f"{tmp}/{i}.json", "--device", "cuda"]
                proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                procs.append(proc)
                logs.append([])
                readers.append(threading.Thread(target=_read_lines, args=(proc, logs[-1]), daemon=True))
                readers[-1].start()
            while not all(any(line == "ready\n" for _, line in log) for log in logs):
                require(all(proc.poll() is None for proc in procs) and time.perf_counter() - t0 < NAIVE_TIMEOUT_S,
                        f"naive x{k}: a process ended or stalled before its warm-up finished: "
                        f"{[[line for _, line in log[-3:]] for log in logs]}")
                time.sleep(0.05)
            warm_s = time.perf_counter() - t0
            start.touch()
            codes = [proc.wait(timeout=NAIVE_TIMEOUT_S) for proc in procs]
            for t in readers:
                t.join(timeout=30)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        results = [json.loads(Path(f"{tmp}/{i}.json").read_text()) if codes[i] == 0 else None for i in range(k)]
    require(all(c == 0 for c in codes), f"naive x{k}: exit codes {codes}; last lines "
            f"{[[line for _, line in log[-3:]] for log in logs]}")
    require(all(np.isfinite(r["final_loss"]) for r in results), f"naive x{k}: losses {[r['final_loss'] for r in results]}")
    steps = [[(t, float(m[2])) for t, line in log if (m := STEP_LINE.search(line))] for log in logs]
    require(all(len(s) == NAIVE_STEPS for s in steps), f"naive x{k}: step lines {[len(s) for s in steps]}")
    begin = max(s[NAIVE_SKIP - 1][0] for s in steps)
    end = min(s[-1][0] for s in steps)
    inside = [[ms for t, ms in s if begin < t <= end] for s in steps]
    require(end > begin and all(len(x) >= 5 for x in inside),
            f"naive x{k}: the processes overlap in too few steps {[len(x) for x in inside]}")
    return {
        "k": k, "arch": NAIVE_ARCH, "batch": RESNET_BATCH, "steps": NAIVE_STEPS, "window_s": end - begin,
        "steps_in_window": [len(x) for x in inside],
        "median_step_ms": [statistics.median(x) for x in inside],
        "aggregate_images_per_s": RESNET_BATCH * sum(len(x) for x in inside) / (end - begin),
        "final_losses": [r["final_loss"] for r in results],
        "warm_up_s": warm_s, "wall_s": time.perf_counter() - t0,
    }


def phase_collocate(resnet_runs: list) -> dict:
    """The characterization on the card, then naive collocation measured at
    k = 2, 4, 7 beside the naive model's cell (``naive x{k}``) built on this
    call's measured solo step. No limit on measured / predicted: a reading."""
    char = characterize(resnet_runs)
    torch.cuda.empty_cache()
    solo_ms = char["solos"][NAIVE_ARCH]["step_ms"]
    readings = []
    for k in NAIVE_KS:
        run = naive_run(k)
        predicted_s = char["cells"][(NAIVE_ARCH, f"naive x{k}")]["records"][0]["step_s"]
        run.update(
            solo_step_ms=solo_ms, solo_images_per_s=RESNET_BATCH / (solo_ms * 1e-3),
            predicted_step_ms=predicted_s * 1e3,
            predicted_aggregate_images_per_s=k * RESNET_BATCH / predicted_s,
        )
        run["measured_over_predicted_images_per_s"] = (
            run["aggregate_images_per_s"] / run["predicted_aggregate_images_per_s"])
        emit("collocate_naive", **run)
        readings.append(run)
    return {"solos": char["solos"], "naive": readings}


def calibration_kernel(kernel: str, counters: dict) -> dict:
    """One family's calibration measurement on the card: its launches, and
    the kernel's outputs held against the plain version on the same inputs,
    in the form of the family's own phase (TOL_BF16 for K1 and K4 against f32;
    TOL_WKV against float64 for K5, as phase_wkv6)."""
    for mod in counters.values():
        mod.launch_count = 0
    meas = calibration.measure_calibration_kernel(ARCH, device=str(DEV), n=CALIB_N, kernel=kernel)
    launches = {name: mod.launch_count for name, mod in counters.items()}
    require(launches == {name: CALIB_RUNS if name == kernel else 0 for name in counters},
            f"calibration {kernel}: launches {launches}, expected {CALIB_RUNS} of {kernel} alone")
    run_it, oracle = calibration.calibration_inputs(kernel, DEV)
    with torch.no_grad():
        got, want = run_it(), oracle()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    tol = TOL_WKV if kernel == "wkv6" else TOL_BF16
    errs = [check(f"calibration {kernel} output {i}", g, w, tol) for i, (g, w) in enumerate(zip(got, want))]
    if kernel != "wkv6":
        require(meas["max_err_vs_ref"] <= TOL_BF16,
                f"calibration {kernel}: max abs err {meas['max_err_vs_ref']} beyond {TOL_BF16}")
    # readings beside the measurement's wall: the kernel's device time (calls
    # queued behind a spin kernel) and the host's time to make one call
    with torch.no_grad():
        device_us, host_us = gpu_ms(run_it, iters=50) * 1e3, host_us_per_call(run_it)
    out = {"kernel": kernel, "shape": calibration.CALIBRATION_SHAPES[kernel], "launches": launches[kernel],
           "wall_us": meas["wall_s"] * 1e6, "device_us": device_us, "host_us_per_call": host_us,
           "max_err_vs_ref": meas["max_err_vs_ref"], "check_max_abs_err": max(errs),
           "tolerance": f"atol=rtol={tol}" + (" against float64" if kernel == "wkv6" else
                                                f"; max abs err {TOL_BF16} against f32")}
    emit("calibrate_kernel", **out)
    return out


def phase_calibrate() -> dict:
    """The calibration loop on the card, then the cluster simulator.

    (a) each family's calibration measurement; (b) ``calibrate --backend
    kernels --skus h100-80gb`` in this process, its K1 launches counted from 0
    (CALIB_PAIRS x CALIB_RUNS; K4 and K5 none) and every measurement it made
    recorded through a wrapper of ``measure_calibration_kernel``; (c)
    ``simulate --seed 0``, the default grid, 0 failures. The wall seconds and
    the sha256 of its ``_summary.json`` are readings: byte identity with the
    reference is held on the CPU (tests/test_torch_cluster.py)."""
    counters = {"flash_attention": fa, "decode_attention": da, "wkv6": rk}
    kernels = {k: calibration_kernel(k, counters) for k in counters}

    measure, made = calibration.measure_calibration_kernel, []

    def recording(arch, **kw):
        made.append((arch, kw, measure(arch, **kw)))
        return made[-1][2]

    calibration.measure_calibration_kernel = recording
    with tempfile.TemporaryDirectory() as tmp:
        for mod in counters.values():
            mod.launch_count = 0
        try:
            t0 = time.perf_counter()
            rc = calibrate.main(["--backend", "kernels", "--skus", CALIB_SKU, "--out", tmp])
            calib_s = time.perf_counter() - t0
        finally:
            calibration.measure_calibration_kernel = measure
        launches = {name: mod.launch_count for name, mod in counters.items()}
        db = CharDB.loads((Path(tmp) / f"calib_db__{CALIB_SKU}.json").read_text())
    require(rc == 0, f"calibrate exited {rc}")
    require(len(made) == CALIB_PAIRS and all(kw == {"device": "cuda", "n": CALIB_N} for _, kw, _ in made),
            f"calibrate measured {[(a, kw) for a, kw, _ in made]}, expected {CALIB_PAIRS} pairs at n={CALIB_N}")
    require(launches == {"flash_attention": CALIB_PAIRS * CALIB_RUNS, "decode_attention": 0, "wkv6": 0},
            f"calibrate launched {launches}, expected {CALIB_PAIRS * CALIB_RUNS} of K1 alone")
    bad = [(a, r["max_err_vs_ref"]) for a, _, r in made if r["kernel"] != "flash_attention"
           or not r["max_err_vs_ref"] <= TOL_BF16]
    require(not bad, f"calibrate's measurements beyond {TOL_BF16} or not of K1: {bad}")
    sku = get_sku(CALIB_SKU)
    counts = db.provenance_counts()
    recs = sorted(db.records.values(), key=lambda r: (r.arch, r.shape, r.profile))
    measured = [r for r in recs if r.provenance == "measured"]
    predicted = [r for r in recs if r.provenance == "predicted"]
    require(counts.get("measured") == CALIB_PAIRS and counts.get("predicted") == CALIB_PAIRS
            and counts.get("refined") == len(db) - 2 * CALIB_PAIRS, f"calibrated DB provenance {counts}")
    require({r.profile for r in measured} == {sku.full_profile} and {r.source for r in measured} == {"kernels"},
            f"measured records at {sorted({r.profile for r in measured})} from {sorted({r.source for r in measured})}")
    require({r.profile for r in predicted} == {sku.profile_order[0]},
            f"predicted records at {sorted({r.profile for r in predicted})}")
    err_of = {a: r["max_err_vs_ref"] for a, _, r in made}
    pairs = [{"arch": r.arch, "shape": r.shape, "profile": r.profile, "compute_us": r.compute_s * 1e6,
              "step_us": r.step_s * 1e6, "max_err_vs_ref": err_of[r.arch]} for r in measured]
    emit("calibrate", sku=CALIB_SKU, launches=launches, provenance=counts, seconds=calib_s, pairs=pairs,
         step_latency_us=sku.step_latency_s * 1e6)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = simulate.main(["--seed", "0", "--out", tmp])
        sim_s = time.perf_counter() - t0
        summary_bytes = (Path(tmp) / "_summary.json").read_bytes()
    summary = json.loads(summary_bytes)
    require(rc == 0 and summary["failures"] == 0, f"simulate exited {rc} with {summary['failures']} failed cells")
    emit("simulate", seed=0, cells=len(summary["cells"]), failures=summary["failures"], seconds=sim_s,
         summary_sha256=hashlib.sha256(summary_bytes).hexdigest())
    return {"kernels": kernels, "launches": launches, "pairs": pairs}


def main() -> None:
    t0 = time.perf_counter()
    device = phase_device()
    cfg = get_config(ARCH)
    slm_cfg = get_config(STABLELM_ARCH)
    phase_build()
    flash = phase_flash(cfg)
    decode = phase_decode(cfg)
    dkv, dq = phase_flash_bwd(cfg)
    d160 = phase_d160(slm_cfg)
    d112 = phase_d112(get_config(ZAMBA_ARCH))
    phase_g1()
    rwkv_cfg = get_config(RWKV_ARCH)
    wkv = phase_wkv6(rwkv_cfg)
    torch.cuda.empty_cache()
    attn_counters = {"flash_attention_fwd": fa, "decode_attention": da}
    served = {}
    for c in (cfg, slm_cfg):
        L = c.n_layers
        served[c.name] = phase_serve(
            c, attn_counters, {"flash_attention_fwd": L, "decode_attention": L * (NEW - 1)}, torch_attention_path,
            {name: (L, BATCH, PROMPT + NEW, c.n_kv_heads, c.resolved_head_dim) for name in ("k", "v")})
        torch.cuda.empty_cache()
    L, d, K = rwkv_cfg.n_layers, rwkv_cfg.d_model, rwkv_cfg.ssm.head_dim
    served_rwkv = phase_serve(
        rwkv_cfg, {"wkv6_scan": rk}, {"wkv6_scan": L}, torch_wkv_path,
        {"wkv": (L, BATCH, d // K, K, K), "tm_x": (L, BATCH, d), "cm_x": (L, BATCH, d)}, wkv_probe)
    emit("serve_rwkv_wkv6_share", wkv6_ms_in_prefill=L * wkv["kernel_ms"],
         share_of_prefill=L * wkv["kernel_ms"] / served_rwkv["prefill_device_ms_median"],
         reckoned="launches x the kernel's time at this shape (phase kernel wkv6_scan) / median prefill device ms")
    torch.cuda.empty_cache()
    # the MoE, mamba2-hybrid and encoder-decoder families (K1 and K4 at G = 1; zamba2's at head_dim 112)
    for arch, prompt in ((DEEPSEEK_ARCH, PROMPT), (ZAMBA_ARCH, PROMPT), (WHISPER_ARCH, WHISPER_PROMPT)):
        c = get_config(arch)
        k1, k4 = SERVE_LAUNCHES[arch]
        shapes = {name: shape for name, (shape, _) in build_model(c).cache_spec(BATCH, prompt + NEW).items()}
        served[arch] = phase_serve(c, attn_counters, {"flash_attention_fwd": k1, "decode_attention": k4},
                                   torch_attention_path, shapes, prompt=prompt,
                                   yardstick=None if arch == WHISPER_ARCH else f32_attention_path)
        torch.cuda.empty_cache()
    trained = phase_train(cfg)
    torch.cuda.empty_cache()
    slm_train = stablelm_train_config()
    slm_step = one_step(slm_train, build_model(slm_train), make_plan(slm_train, None), STABLELM_TOL)
    torch.cuda.empty_cache()
    olmoe_train = olmoe_train_config()
    stepped = {OLMOE_ARCH: one_step(olmoe_train, build_model(olmoe_train), make_plan(olmoe_train, None), OLMOE_TOL)}
    torch.cuda.empty_cache()
    wcfg = get_config(WHISPER_ARCH)
    stepped[WHISPER_ARCH] = one_step(wcfg, build_model(wcfg), make_plan(wcfg, None), WHISPER_TOL, batch_size=BATCH,
                                     seq=WHISPER_PROMPT + NEW)
    torch.cuda.empty_cache()
    resnet_runs = phase_resnet()["runs"]
    torch.cuda.empty_cache()
    phase_collocate(resnet_runs)
    calib = phase_calibrate()
    calib_k = calib["kernels"]

    def row(k, source, replaces, launches):
        return {
            "name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }

    def at_dim(recs, name, launches):
        k = recs[name]
        return {"shape": k["shape"], "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"], "library_backend": k["library_backend"],
                "launches": launches, "max_abs_err": k["max_abs_err"], "guard_max_abs_err": k["guard_max_abs_err"]}

    def at160(name, launches):
        return at_dim(d160, name, launches)

    new_archs = (DEEPSEEK_ARCH, ZAMBA_ARCH, WHISPER_ARCH)
    served_by = {name: {a: served[a]["launches"][name] for a in new_archs}
                 for name in ("flash_attention_fwd", "decode_attention")}
    # (K1, K2, K3) of the one-step checks of olmoe-1b-7b (depth 2) and whisper-base
    stepped_by = [{a: r["launches"][i] for a, r in stepped.items()} for i in range(3)]

    # launches: K1 and K4 on granite's serving path, K2 and K3 on its
    # training path (TRAIN_STEPS steps), K5 on rwkv6's serving path; K1's
    # count on the training path beside its own. At head_dim 160 (d160):
    # K1 and K4 on stablelm-12b's serving path, K2 and K3 on its one step.
    # On the calibration path: K1 in ``calibrate --backend kernels``
    # (launches_calibrate), and K1, K4 and K5 in one calibration measurement
    # each (launches_calibrate_kernel). At head_dim 112 (d112): K1 and K4 on
    # zamba2-7b's serving path. launches_serve: K1 and K4 on the serving paths
    # of deepseek-moe-16b, zamba2-7b and whisper-base; launches_one_step: K1,
    # K2 and K3 in the one-step checks of olmoe-1b-7b and whisper-base.
    bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    slm_served = served[slm_cfg.name]["launches"]
    slm_k1, slm_k2, slm_k3 = slm_step["launches"]
    emit("wall", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [
        dict(row(flash, "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
                 "src/repro/kernels/flash_attention.py:159", served[cfg.name]["launches"]["flash_attention_fwd"]),
             launches_train=trained["launches"]["flash_attention_fwd"],
             max_abs_err_train=dkv["forward_max_abs_err"],
             launches_calibrate=calib["launches"]["flash_attention"],
             launches_calibrate_kernel=calib_k["flash_attention"]["launches"],
             d160=dict(at160("flash_attention_fwd", slm_served["flash_attention_fwd"]), launches_train=slm_k1),
             d112=at_dim(d112, "flash_attention_fwd", served[ZAMBA_ARCH]["launches"]["flash_attention_fwd"]),
             launches_serve=served_by["flash_attention_fwd"], launches_one_step=stepped_by[0]),
        dict(row(decode, "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:126", served[cfg.name]["launches"]["decode_attention"]),
             launches_calibrate_kernel=calib_k["decode_attention"]["launches"],
             d160=at160("decode_attention", slm_served["decode_attention"]),
             d112=at_dim(d112, "decode_attention", served[ZAMBA_ARCH]["launches"]["decode_attention"]),
             launches_serve=served_by["decode_attention"]),
        dict(row(dkv, bwd_src, dkv["replaces"], trained["launches"]["flash_attention_bwd_dkv"]),
             d160=at160("flash_attention_bwd_dkv", slm_k2), launches_one_step=stepped_by[1]),
        dict(row(dq, bwd_src, dq["replaces"], trained["launches"]["flash_attention_bwd_dq"]),
             d160=at160("flash_attention_bwd_dq", slm_k3), launches_one_step=stepped_by[2]),
        dict(row(wkv, "src/repro_torch/kernels/csrc/wkv6_scan.cu", wkv["replaces"],
                 served_rwkv["launches"]["wkv6_scan"]),
             launches_calibrate_kernel=calib_k["wkv6"]["launches"],
             pytorch_yardstick_ms=wkv["chunked_ms"], pytorch_yardstick="models.rwkv6.wkv_chunked"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
