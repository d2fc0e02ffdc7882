"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card, at the shape its main path
gives it and at ragged small shapes: K1-K4 at head_dim 64 (granite-3-2b) and
at head_dim 160 (stablelm-12b, with a guard case on the first 160 columns of
buffers 192 wide), K1-K4 at head_dim 112 (zamba2-7b, a guard case on
buffers 128 wide) and at one query head a KV head (deepseek-moe-16b's and
whisper-base's shapes, K2/K3 at whisper's cross attention), K5 at
rwkv6-1.6b's; and K1-K4 on the work of each rank of a ``model`` axis of 16
that divides the query heads but not the KV heads (phase_shards: K1-K3 on
each rank's query heads and the KV head they read at granite-3-2b's and
llama3-8b's training shapes, K4 with its log-sum-exp on each rank's rows of
sequence-sharded decode caches, merged; and where it does not divide the
query heads, K1-K3 on each rank's row_split share of heads and query rows,
a zig-zag of two slices under a causal mask, at whisper-base's self and
cross attention and llava-next-34b's G 7, ranks 0's and 1's timed),
against the whole-head and whole-cache calls. Then it drives the port's entry points at full size, random
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
    at full width and depth 2, zamba2-7b at full width and depth 4 (its
    shared attention block twice), whisper-base at full size -- the same
    one-step check;
  * the multi-device substrate (phase_mesh) -- under NCCL at world 1 (one
    process on card 0, a 1 x 1 mesh): granite-3-2b's sharded train step
    (baseline, sp, zero) against the single-device step at the training
    setup, the sharded decode (baseline, serve) and prefill, EF-int8, the
    ring matmuls and GPipe; the multi-rank semantics are held on the CPU by
    gloo (tests/test_torch_mesh_ranks.py and its neighbours); then the vlm,
    moe and encdec families' sharded steps the same way (phase_mesh_families:
    llava-next-34b, olmoe-1b-7b and whisper-base training, baseline and sp;
    deepseek-moe-16b and whisper-base prefill and decode, baseline and
    serve), then the hybrid, rwkv and resnet families' (phase_mesh_recurrent:
    zamba2-7b training at depth 4 and serving at depth 6, rwkv6-1.6b serving
    at full size, K5 on each rank's heads and batch rows, resnet_small's
    step; a sharded rwkv6 train step on the card must raise, K5 having no
    backward);
  * the multi-pod dry-run (phase_dryrun) -- ``python -m repro_torch.launch.
    dryrun`` for granite-3-2b train_4k on a fake 256-rank group and for
    deepseek-moe-16b decode_32k on a fake 512-rank group, in processes of
    their own; then granite's training step lowered at a fake 1 x 1 mesh
    against the same step on the card at world 1 on the non-kernel path
    (fingerprint and FLOPs equal);
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
    naive model's prediction; then the LM workloads (phase_collocate_lm):
    granite-3-2b's train_4k step at full width, accumulated from micro
    batches of 2 to a global batch of COLLOCATE_LM_BATCH, over every cell of
    the grid in this process, its counted step's kernel entries (K1-K3 seen
    by the op counters) against the launch counters and the FLOP reckoning;
    granite's prefill and decode cells on the whole card; llama3-8b skipped,
    its train state beyond the card, nothing allocated;
  * the examples/ twins (phase_examples), each through its ``main(argv)``:
    quickstart at llama3-8b's full width and depth 2 (head_dim 128, four
    query heads a KV head; K1-K4 against their plain versions at the
    shapes the twin gives them, one step at batch 2, seq 4096 against the
    non-kernel path, then 30 steps, the checkpoint restored bit for bit, 8
    tokens generated with every K1 and K4 call held to its plain version on
    its own inputs), train_lm's lm-100m at its own size (200 steps, the
    loss falls), the sweep's seven granite-3-2b jobs at depth 2 on the
    card's seven 1g.10gb instances, alone and then each in a thread on a
    stream of its own (traces equal bit for bit, solo peaks within the
    instances' budgets), and the failover (the resumed job against an
    uninterrupted run);
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
import importlib.util
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

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs.base import ShapeSuite  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.models import attention, module, moe, resnet, rwkv6, transformer  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402
from repro_torch.core.device import get_sku  # noqa: E402
from repro_torch.core.instance import InstanceRecord, InstanceRuntime, JobSpec, measure_job  # noqa: E402
from repro_torch.core import instance  # noqa: E402
from repro_torch.core.metrics import collocation_speedup  # noqa: E402
from repro_torch.core.partitioner import partition  # noqa: E402
from repro_torch.core.profiles import Placement  # noqa: E402
from repro_torch.telemetry import counts  # noqa: E402
from repro_torch.core.calib.records import CharDB  # noqa: E402
from repro_torch.kernels import calibration  # noqa: E402
from repro_torch.launch import calibrate, collocate, simulate, train  # noqa: E402
from repro_torch.models.module import (  # noqa: E402
    param_bytes, param_count, tree_leaves, tree_map, tree_paths, tree_unflatten,
)
from repro_torch.runtime import train_step  # noqa: E402
from repro_torch.sharding import dist  # noqa: E402
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
# zamba2-7b's one-step training check: full width, ZAMBA_TRAIN_LAYERS mamba2
# layers in groups of ZAMBA_TRAIN_EVERY, so the shared attention block (K1-K3
# at head_dim 112) runs twice, before each group, as it runs before each of
# the full model's three groups of 27
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_EVERY = 4, 2
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
# phase_shards: the ranks of a ``model`` axis of 16, one after another on the
# card (granite-3-2b, llama3-8b, stablelm-12b and qwen2-72b there split their
# query heads but not their 8 KV heads), and decode_32k's sequence length,
# over which the caches of those ranks are split
SHARD_TP, SHARD_SEQ, QUICKSTART_ARCH = 16, 32768, "llama3-8b"
# phase_shards where that axis does not divide the query heads (dist.row_split):
# (name, arch, batch, query rows, KV rows, causal) at a device's training
# shapes -- whisper-base's self attention (8 heads: 8 groups of one head, two
# parts of the rows each, the causal zig-zag's two slices a part) and cross
# attention over its 1500 frames,
# llava-next-34b's 56 heads (8 groups of 7, one KV head each); the plain
# versions on the first ROW_PLAIN_B sequences
ROW_SHARE_CASES = (("whisper-base self", "whisper-base", 16, 4096, 4096, True),
                   ("whisper-base cross", "whisper-base", 16, 4096, 1500, False),
                   ("llava-next-34b", "llava-next-34b", 2, 4096, 4096, True))
ROW_PLAIN_B = 2
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
# the LM characterization (phase_collocate_lm): granite-3-2b at full width and
# TRAIN_SEQ under ``collocate.characterize_workload`` at this global batch, so
# a step accumulates COLLOCATE_LM_BATCH // collocate.LM_MICRO_BATCH micro
# batches (the CLI's LM_SUITE, batch 256, runs apart from this script); its
# serving cells at the shapes of phase_serve; the workload it must skip, whose
# reckoned train state exceeds the card
COLLOCATE_LM_BATCH, COLLOCATE_LM_SKIPPED = 16, "llama3-8b"
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
# zamba2-7b's one-step check (head_dim 112, full width, depth 4, the shared
# block twice), set the same way from two readings on an H100 of K3 with its
# 128-row KV tiles: the sound kernels 0.0255 (attention) and 0.0322 (the
# rest), `dq_skip_diag` planted in K3 0.375 and 0.196
# (examples/profile_flash_bwd_torch.py --variants dq_skip_diag). At depth 4 the
# hybrid's drift between two roundings (ROADMAP Queue 3, "held differently")
# stays within granite's limits, so it is held like granite, not to the
# spread of two non-kernel paths.
ZAMBA_TOL = (TOL_LOSS, 0.097, 0.079)
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
    ``decode``, by rebinding the two names the models call: ``attend``'s
    ``flash_attention`` and the transformer's ``decode_attention`` (the
    families built on it call that too). The package itself has no such
    switch: its dispatch reads only its arguments. ``flash`` returns what the
    models' own does, the output as ``wo``'s input, (B, S, H·D)."""
    saved = attention.flash_attention, transformer.decode_attention
    attention.flash_attention, transformer.decode_attention = flash, decode
    try:
        yield
    finally:
        attention.flash_attention, transformer.decode_attention = saved


def torch_attention_path():
    """The non-kernel PyTorch attention functions, as a context manager."""
    def flash(q, k, v, **kw):
        return attention.xla_flash_attention(q, k, v, **kw).flatten(2)

    return attention_rebound(flash, attention.torch_decode_attention)


def f32_attention_path():
    """The plain f32 versions of ``kernels/ref.py`` (no bf16 rounding of
    q * scale or of p), as a context manager: a second non-kernel path that
    differs from ``torch_attention_path`` in rounding only."""
    def flash(q, k, v, *, causal=True, block_k=None, q_offset=0, scale=None, kv_len=None):
        return ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset, scale=scale).flatten(2)

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
    for lib, n_inst in (("flash_attention_fwd", 8), ("flash_attention_bwd", 16), ("decode_attention", 8),
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


def decode_timed(gen, B, smax, H, KVH, D, kv_n, lse: bool = False) -> dict:
    """K4 at one bf16 shape and kv_len: its time beside the plain version's,
    one library call's (with the backend it ran) and the bound. As in the
    model, every layer has its own cache, so a launch finds its cache cold:
    the launches cycle over more layers than the 50 MB L2 holds. With
    ``lse``, also the time of flash-decode's partial (o in f32 and the
    log-sum-exp), ``kernel_lse_ms``, in turns with the plain output."""
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
    timed_lse = {}
    if lse:
        timed_lse["kernel_lse_ms"] = gpu_ms(cycle(lambda a, b: da.decode_attention(q, a, b, kv_len, return_lse=True)),
                                            iters=40)
        timed_lse["kernel_again_ms"] = gpu_ms(cycle(lambda a, b: da.decode_attention(q, a, b, kv_len)), iters=40)
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
        "kernel_ms": kernel_ms, **timed_lse, "plain_ms": plain_ms, "library_ms": library_ms,
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


# (query row, key) pairs that attention does not mask, over all heads: the
# package's count, which the op counters' kernel entries use too
live_pairs = fa.live_pairs


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


def zamba_train_config():
    """zamba2-7b at full width, ZAMBA_TRAIN_LAYERS layers in groups of
    ZAMBA_TRAIN_EVERY: the one-step check at head_dim 112."""
    return dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_TRAIN_LAYERS, attn_every=ZAMBA_TRAIN_EVERY)


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
    """K1-K4 at head_dim 112 (zamba2-7b's shared attention block): K1 and K4
    at the serving shape, K2 and K3 at the training shape (B 2, S 4096,
    H = KVH 32, causal), each timed beside its bound, its plain version and
    the library call for the same function; all four at ragged small shapes
    (causal and not, q_offset > 0, G 1, 3, 4 and 130, f16), then the guard
    case on the first 112 columns of buffers D112_GUARD_WIDTH wide. Returns
    each kernel's record by name."""
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
    bwd_cases = [
        flash_bwd_case(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, KVH, D, True, by_rows=True, repeat=True),
        flash_bwd_case(gen, 1, 101, 101, 4, 4, D, True),                        # G=1, ragged
        flash_bwd_case(gen, 2, 77, 131, 8, 2, D, False),                        # non-causal, Sq < Skv, G=4
        flash_bwd_case(gen, 1, 131, 77, 6, 2, D, False, dtype=f16),             # non-causal, Sq > Skv, G=3, f16
        flash_bwd_case(gen, 2, 99, 99, 8, 2, D, True, q_offset=64),             # q_offset > 0
        flash_bwd_case(gen, 1, 257, 257, 4, 4, D, True, dtype=f16),             # three dk/dv blocks of 128 rows, f16
        flash_bwd_case(gen, 1, 5, 40, 130, 1, D, True, q_offset=35),            # G=130: one position a tile
    ]
    torch.cuda.empty_cache()
    guard = guard_case(gen, D=D, width=D112_GUARD_WIDTH)
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


def phase_g7(cfg) -> dict:
    """K1-K4 at llava-next-34b's heads (56 query heads over 8 KV heads, G = 7,
    head_dim 128), which phase mesh_families trains at depth LLAVA_MESH_LAYERS
    and no other phase gives the kernels: K1 and K2/K3 at its training shape
    (B 2, S 4096, causal; the backward twice, bit-identical), and K1-K4 at
    ragged small shapes with G 7 (causal and not, Sq against Skv both ways,
    q_offset > 0, f16), each held to its plain version at the tolerances of
    the other head_dims."""
    gen = torch.Generator(device=DEV).manual_seed(10)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    require((H // KVH, D) == (7, 128) and H % KVH == 0, f"{cfg.name} has G {H / KVH}, head_dim {D}")
    f16 = torch.float16
    flash = [
        flash_case(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, KVH, D, True, by_rows=True),  # the training shape
        flash_case(gen, 2, 77, 131, 14, 2, D, False),                                      # ragged, Sq < Skv
        flash_case(gen, 1, 131, 77, 7, 1, D, False, dtype=f16),                            # ragged, Sq > Skv, f16
        flash_case(gen, 2, 33, 97, 14, 2, D, True, q_offset=64),                           # q_offset > 0
        flash_case(gen, 1, 130, 130, 21, 3, D, True),                                      # three 64-row kv tiles
    ]
    torch.cuda.empty_cache()
    decode = decode_case(gen, 2, 333, 14, 2, D, [1, 77, 333])
    decode += decode_case(gen, 1, 130, 7, 1, D, [130], dtype=f16)
    bwd = [
        flash_bwd_case(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, KVH, D, True, by_rows=True, repeat=True),
        flash_bwd_case(gen, 1, 101, 101, 7, 1, D, True),                                   # ragged
        flash_bwd_case(gen, 2, 77, 131, 14, 2, D, False),                                  # non-causal, Sq < Skv
        flash_bwd_case(gen, 1, 131, 77, 7, 1, D, False, dtype=f16),                        # non-causal, Sq > Skv, f16
        flash_bwd_case(gen, 2, 99, 99, 14, 2, D, True, q_offset=64),                       # q_offset > 0
        flash_bwd_case(gen, 1, 257, 257, 21, 3, D, True),                                  # several dk/dv blocks
    ]
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "flash_attention_fwd": flash, "decode_attention": decode, "flash_attention_bwd": bwd,
           "tolerance": f"{TOL_ROW_RMS} * rms(row) + 1 ulp at the training shape, {TOL_BF16} at the small ones"}
    emit("kernel_g7", **out)
    return out


class EmulatedRank:
    """What ``dist.row_split`` reads of a ``DeviceMesh``: rank ``rank`` of a
    ``model`` axis of ``tp`` ranks. It lets one card do, in turn, the work
    that each rank of a (data, model) mesh would do."""

    def __init__(self, tp: int, rank: int):
        self.mesh_dim_names, self.mesh, self.rank = ("data", "model"), torch.empty(1, tp), rank

    def get_local_rank(self, name: str) -> int:
        require(name == dist.TP_AXIS, f"no mesh dim {name}")
        return self.rank


def shard_flash_case(gen, B, S, H, KVH, D, tp) -> dict:
    """K1, K2 and K3 on each of ``tp`` ``model`` ranks' query heads and the KV
    heads those read (``dist.row_split``, one slice of rows), as the sharded steps run them
    where ``model`` divides the query heads but not the KV heads: the ranks'
    o, lse and dq concatenated and their dk, dv summed over the ranks that
    share a KV head (in f32, as the partial sum over ``model`` adds them),
    against the whole-head calls and against the plain versions."""
    q, do = randn(gen, (B, S, H, D)), randn(gen, (B, S, H, D))
    k, v = randn(gen, (B, S, KVH, D)), randn(gen, (B, S, KVH, D))
    kw = dict(causal=True, scale=D**-0.5)
    o_w, lse_w = fa.flash_attention_fwd(ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), **kw)
    dq_w, dk_w, dv_w = fa.flash_attention_bwd(ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), o_w, lse_w,
                                              ops._fold(do, KVH), **kw)
    o_w, dq_w, lse_w = ops._unfold(o_w), ops._unfold(dq_w), lse_w.permute(0, 2, 1, 3).reshape(B, S, H)
    dk_w, dv_w = dk_w.permute(0, 2, 1, 3), dv_w.permute(0, 2, 1, 3)
    o, dq, lse = torch.empty_like(q), torch.empty_like(q), torch.empty(B, S, H, device=DEV)
    dk, dv = torch.zeros(k.shape, device=DEV), torch.zeros(v.shape, device=DEV)
    launches0 = fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count
    groups = set()
    for r in range(tp):
        pick = dist.row_split(EmulatedRank(tp, r), H, KVH).kv
        heads = slice(r * H // tp, (r + 1) * H // tp)
        kl, vl = k[:, :, pick], v[:, :, pick]  # views of the whole K/V, read in place
        kvh = kl.shape[2]
        qf, dof = ops._fold(q[:, :, heads], kvh), ops._fold(do[:, :, heads], kvh)
        groups.add((kvh, qf.shape[3]))
        o_r, lse_r = fa.flash_attention_fwd(qf, ops._kv_fold(kl), ops._kv_fold(vl), **kw)
        dq_r, dk_r, dv_r = fa.flash_attention_bwd(qf, ops._kv_fold(kl), ops._kv_fold(vl), o_r, lse_r, dof, **kw)
        o[:, :, heads], dq[:, :, heads] = ops._unfold(o_r), ops._unfold(dq_r)
        lse[:, :, heads] = lse_r.permute(0, 2, 1, 3).reshape(B, S, -1)
        dk[:, :, pick] += dk_r.permute(0, 2, 1, 3).float()
        dv[:, :, pick] += dv_r.permute(0, 2, 1, 3).float()
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip((fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count), launches0)]
    require(launches == [tp] * 3, f"the ranks' calls launched {launches}, not {tp} of each kernel")
    label = f"shards of flash B{B} S{S} H{H} KVH{KVH} D{D} over {tp} model ranks"
    out = {"shape": f"q ({B},{S},{H},{D}) k/v ({B},{S},{KVH},{D}) bf16 causal, {tp} ranks",
           "local_groups": sorted(groups), "launches": dict(zip(("fwd", "dkv", "dq"), launches))}
    # against the whole-head calls: the same kernels, other tiles of rows
    out["vs_whole"] = {"o": check_rows(label + " o vs whole", o, o_w)["max_abs_err"],
                       "lse": check(label + " lse vs whole", lse, lse_w, TOL_LSE),
                       "dq": check_rows(label + " dq vs whole", dq, dq_w)["max_abs_err"]}
    for name, got, want in (("dk", dk, dk_w), ("dv", dv, dv_w)):
        floor = TOL_GRAD_FLOOR * want.float().square().mean().sqrt().item()
        out["vs_whole"][name] = check_rows(f"{label} {name} vs whole", got.to(want.dtype), want, floor)["max_abs_err"]
    del o_w, dq_w, dk_w, dv_w
    torch.cuda.empty_cache()
    # against the plain versions of the whole call
    o_ref, lse_ref = ref.mha_reference_with_lse(q, k, v, **kw)
    out["vs_plain"] = {"o": check_rows(label + " o", o, o_ref)["max_abs_err"],
                       "lse": check(label + " lse", lse, lse_ref, TOL_LSE)}
    del o_ref, lse_ref
    torch.cuda.empty_cache()
    lse_f = lse.reshape(B, S, KVH, H // KVH).permute(0, 2, 1, 3).contiguous()
    want = ref.flash_attention_bwd_reference(ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), ops._fold(o, KVH),
                                             lse_f, ops._fold(do, KVH), **kw)
    for name, got, w in (("dq", dq, ops._unfold(want[0])), ("dk", dk, want[1].permute(0, 2, 1, 3)),
                         ("dv", dv, want[2].permute(0, 2, 1, 3))):
        floor = TOL_GRAD_FLOOR * w.float().square().mean().sqrt().item()
        out["vs_plain"][name] = check_rows(f"{label} {name}", got.to(w.dtype), w, floor)["max_abs_err"]
    del want
    torch.cuda.empty_cache()
    return out


def stacked_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """The all-reduce over the emulated ranks, whose partials are stacked on dim 0."""
    return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)


def shard_decode_case(gen, B, smax, H, KVH, D, tp, lens) -> list:
    """K4 with its log-sum-exp on each of ``tp`` sequence shards of one
    layer's caches, as each rank of a sequence-sharded cache runs it, the
    partials merged (``ops.merge_partials``), against K4 on the whole caches
    and the plain version, at each kv_len of ``lens``: shards past kv_len
    must give o = 0 and lse = -inf, and nothing may be NaN."""
    q = randn(gen, (B, H, D))
    kc, vc = randn(gen, (B, smax, KVH, D)), randn(gen, (B, smax, KVH, D))
    rows = smax // tp
    kv_len = torch.zeros(1, dtype=torch.int32, device=DEV)
    cases = []
    for n in lens:
        kv_len.fill_(n)
        launches0 = da.launch_count
        parts = [da.decode_attention(q, kc[:, r * rows:(r + 1) * rows], vc[:, r * rows:(r + 1) * rows],
                                     ops.local_kv_len(kv_len, r * rows, rows), return_lse=True) for r in range(tp)]
        o, lse = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
        merged = ops.merge_partials(o, lse, stacked_reduce, q.dtype)[0]
        whole = da.decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        require(da.launch_count - launches0 == tp + 1, "the decode wrapper did not count the shards' launches")
        label = f"decode shards B{B} Smax{smax} H{H} KVH{KVH} D{D} over {tp} ranks kv_len={n}"
        empty = [r for r in range(tp) if r * rows >= n]
        require(all(bool(torch.isneginf(lse[r]).all()) and bool((o[r] == 0).all()) for r in empty),
                f"{label}: a shard past kv_len gave other than o = 0, lse = -inf")
        require(not merged.isnan().any(), f"{label}: the merge gave NaN")
        want_o, want_lse = zip(*(ref.decode_attention_reference(q, kc[:, r * rows:(r + 1) * rows],
                                                                vc[:, r * rows:(r + 1) * rows],
                                                                kv_len=max(0, min(n - r * rows, rows)), return_lse=True)
                                 for r in range(tp)))
        live = [r for r in range(tp) if r not in empty]
        plain = ref.decode_attention_reference(q, kc, vc, kv_len=n)
        cases.append({
            "B": B, "Smax": smax, "H": H, "KVH": KVH, "D": D, "kv_len": n, "empty_shards": len(empty),
            "shard_o_max_abs_err": check(label + " shard o", o[live], torch.stack(want_o)[live], TOL_BF16),
            "shard_lse_max_abs_err": check(label + " shard lse", lse[live], torch.stack(want_lse)[live], TOL_LSE),
            "merged_vs_whole_max_abs_err": check(label + " merged vs whole", merged, whole, TOL_BF16),
            "merged_max_abs_err": check_rows(label + " merged", merged, plain)["max_abs_err"],
        })
    return cases


def emulated_all_to_all(sent: list) -> list:
    """An all-to-all over emulated ranks: ``sent[k]`` is rank k's (buffer,
    elements to each rank, elements from each rank); rank j receives each
    rank's chunk for it, in rank order."""
    offsets = [[sum(to_each[:j]) for j in range(len(to_each))] for _, to_each, _ in sent]
    received = []
    for j, (_, _, from_each) in enumerate(sent):
        chunks = [buf[offsets[k][j]:offsets[k][j] + to_each[j]] for k, (buf, to_each, _) in enumerate(sent)]
        require([c.numel() for c in chunks] == list(from_each), "an emulated all-to-all's splits disagree")
        received.append(torch.cat(chunks))
    return received


def row_share_operands(q_cols, k_cols, v_cols, H, KVH, D, tp, causal, theta) -> list:
    """Each of ``tp`` ranks' row share operands as the sharded steps build
    them (``ops.row_share_inputs``), from the projections' column blocks of
    q (B, S, H·D), k and v (B, Skv, KVH·D): q's share by the exchange
    ``RowShareExchange.to_rows`` and the KV heads it reads by ``KvToShare``,
    both on emulated ranks through their pure functions, then RoPE (where
    ``theta`` is given) on the share by the steps' ``attention.rope_on_share``,
    q at its rows' positions and k on every row, from the whole sequence's
    tables. (share, q (B, R, Hg, D), k, v (B, Skv, n, D)) a rank."""
    B, S = q_cols.shape[:2]
    Skv = k_cols.shape[1]
    shares = [dist.row_split(EmulatedRank(tp, r), H, KVH) for r in range(tp)]
    qx = [ops.RowShareExchange(share, S, H, D, tp, causal) for share in shares]
    kvx = [ops.KvToShare(H, KVH, D, tp, r) for r in range(tp)]
    qs = [ex.unpack_rows(buf) for ex, buf in zip(qx, emulated_all_to_all(
        [(ex.pack_cols(b), *ex.splits(B, to_rows=True)) for ex, b in zip(qx, q_cols.chunk(tp, dim=-1))]))]
    kv_cols = torch.cat([k_cols, v_cols])
    kvs = [ex.unpack(buf, 2 * B, Skv).unflatten(-1, (-1, D)).chunk(2) for ex, buf in zip(kvx, emulated_all_to_all(
        [(ex.pack(b), *ex.splits(2 * B * Skv)) for ex, b in zip(kvx, kv_cols.chunk(tp, dim=-1))]))]
    del kv_cols
    out = []
    for share, q, (k, v) in zip(shares, qs, kvs):
        if theta is not None:
            tables = module.rope_tables(torch.arange(S, device=DEV), D, theta)
            q, k = attention.rope_on_share(q, k, share.rows(S, causal=causal), tables)
        out.append((share, q, k, v))
    return out


def row_share_cache_rows(operands, KVH, tp) -> list:
    """Prefill's cache rows from the ranks' shares (``row_share_operands``)
    as ``ops.write_row_share_cache`` makes them where the cache lies in its
    rows over ``model``: each rank's own column block of its share's K and V
    (``ops.cache_exchange``) to every rank's rows by the exchange's pure
    functions on emulated ranks. Rank t's (2B, S/tp, KVH, D), K's rows then
    V's."""
    sent = []
    for t, (share, _, k, v) in enumerate(operands):
        own, ex = ops.cache_exchange(k, v, share, KVH, tp, t)
        sent.append((ex, own))
    B = operands[0][2].shape[0]
    return [ex.unpack_rows(buf) for (ex, _), buf in zip(sent, emulated_all_to_all(
        [(ex.pack_cols(own), *ex.splits(2 * B, to_rows=True)) for ex, own in sent]))]


def row_share_case(gen, B, Sq, Skv, H, KVH, D, tp, causal, theta=None) -> dict:
    """K1, K2 and K3 on each of ``tp`` ``model`` ranks' ``dist.row_split``
    shares, as the sharded steps run them where ``model`` does not divide the
    query heads: a group's query heads on each slice of the query rows that
    the rank holds (under a causal mask two, the zig-zag; a call each, its
    ``q_offset`` moved to the slice's first row) and the KV heads they read,
    all KV rows, built from the projections' column blocks as the steps build
    them (``row_share_operands``; RoPE on the share where ``theta`` is
    given), each share first required to be the whole RoPE'd tensors' slice,
    bit for bit, and, for a self attention whose rows ``model`` divides,
    prefill's cache rows from the shares (``row_share_cache_rows``) the
    whole RoPE'd K's and V's. The kernels run through the steps' own
    ``ops.flash_on_share`` and its autograd backward, called a slice at a
    time on a view of the share's rows, so that each call's dk and dv reach
    the check as the kernel rounded them (the steps add a share's two in
    bf16, one rounding more). The ranks' o, lse and dq placed where their
    slices lie and their dk, dv summed in f32 over the calls and the ranks
    that read each KV head, against the whole-head calls on the whole RoPE'd
    tensors, and on the first ``ROW_PLAIN_B`` sequences against the plain
    versions of the whole call."""
    q_cols, do = randn(gen, (B, Sq, H * D)), randn(gen, (B, Sq, H, D))
    k_cols, v_cols = randn(gen, (B, Skv, KVH * D)), randn(gen, (B, Skv, KVH * D))
    operands = row_share_operands(q_cols, k_cols, v_cols, H, KVH, D, tp, causal, theta)
    q, k, v = q_cols.unflatten(-1, (H, D)), k_cols.unflatten(-1, (KVH, D)), v_cols.unflatten(-1, (KVH, D))
    if theta is not None:
        q = module.apply_rope(q, torch.arange(Sq, device=DEV), theta)
        k = module.apply_rope(k, torch.arange(Skv, device=DEV), theta)
    del q_cols, k_cols, v_cols
    for share, qs, ks, vs in operands:
        lo, hi = share.kv_span()
        require(torch.equal(qs, torch.cat([q[:, r, share.heads] for r in share.rows(Sq, causal=causal)], dim=1))
                and torch.equal(ks, k[:, :, lo:hi]) and torch.equal(vs, v[:, :, lo:hi]),
                f"a row share built from the column blocks is not the whole tensors' slice (H{H} KVH{KVH} D{D})")
    if Sq == Skv and Skv % tp == 0:
        n = Skv // tp
        for t, rows in enumerate(row_share_cache_rows(operands, KVH, tp)):
            require(torch.equal(rows[:B], k[:, t * n:(t + 1) * n]) and torch.equal(rows[B:], v[:, t * n:(t + 1) * n]),
                    f"prefill's cache rows from the row shares are not the whole K's and V's (H{H} KVH{KVH} D{D})")
    kw = dict(causal=causal, scale=D**-0.5)
    o_w, lse_w = fa.flash_attention_fwd(ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), **kw)
    dq_w, dk_w, dv_w = fa.flash_attention_bwd(ops._fold(q, KVH), ops._kv_fold(k), ops._kv_fold(v), o_w, lse_w,
                                              ops._fold(do, KVH), **kw)
    o_w, dq_w, lse_w = ops._unfold(o_w), ops._unfold(dq_w), lse_w.permute(0, 2, 1, 3).reshape(B, Sq, H)
    dk_w, dv_w = dk_w.permute(0, 2, 1, 3), dv_w.permute(0, 2, 1, 3)
    o, dq, lse = torch.empty_like(q), torch.empty_like(q), torch.empty(B, Sq, H, device=DEV)
    dk, dv = torch.zeros(k.shape, device=DEV), torch.zeros(v.shape, device=DEV)
    launches0 = fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count
    shares, calls = set(), 0
    for share, q_share, kl, vl in operands:
        heads, (lo, hi), row = share.heads, share.kv_span(), 0
        kvh = hi - lo if isinstance(share.kv, slice) else len(share.kv)
        kl, vl = kl.requires_grad_(), vl.requires_grad_()
        for rows in share.rows(Sq, causal=causal):
            n = rows.stop - rows.start
            q_r = q_share[:, row:row + n].requires_grad_()  # a view of the share's rows, as the steps pass it
            row += n
            shares.add((kvh, (heads.stop - heads.start) // kvh, n, rows.start))
            o_r, (lse_r,) = ops.flash_on_share(q_r, kl, vl, share, (rows,), causal)
            dq_r, dk_r, dv_r = torch.autograd.grad(o_r, (q_r, kl, vl), do[:, rows, heads])
            o[:, rows, heads], dq[:, rows, heads] = o_r.detach(), dq_r
            lse[:, rows, heads] = lse_r.permute(0, 2, 1, 3).reshape(B, n, -1)
            dk[:, :, lo:hi] += dk_r.float()
            dv[:, :, lo:hi] += dv_r.float()
            calls += 1
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip((fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count), launches0)]
    require(launches == [calls] * 3 and calls == tp * (2 if causal else 1),
            f"the ranks' {calls} calls launched {launches} of each kernel")
    label = f"row shares of flash B{B} Sq{Sq} Skv{Skv} H{H} KVH{KVH} D{D} causal={causal} over {tp} model ranks"
    out = {"shape": f"q ({B},{Sq},{H},{D}) k/v ({B},{Skv},{KVH},{D}) bf16 causal={causal}, {tp} ranks",
           "shares": [dict(zip(("kv_heads", "group", "rows", "q_offset"), sh)) for sh in sorted(shares)],
           "launches": dict(zip(("fwd", "dkv", "dq"), launches))}
    out["vs_whole"] = {"o": check_rows(label + " o vs whole", o, o_w)["max_abs_err"],
                       "lse": check(label + " lse vs whole", lse, lse_w, TOL_LSE),
                       "dq": check_rows(label + " dq vs whole", dq, dq_w)["max_abs_err"]}
    for name, got, want in (("dk", dk, dk_w), ("dv", dv, dv_w)):
        floor = TOL_GRAD_FLOOR * want.float().square().mean().sqrt().item()
        out["vs_whole"][name] = check_rows(f"{label} {name} vs whole", got.to(want.dtype), want, floor)["max_abs_err"]
    del o_w, dq_w, dk_w, dv_w
    torch.cuda.empty_cache()
    # against the plain versions of the whole call, on the first sequences
    b = slice(0, ROW_PLAIN_B)
    o_ref, lse_ref = ref.mha_reference_with_lse(q[b], k[b], v[b], **kw)
    out["vs_plain"] = {"sequences": ROW_PLAIN_B, "o": check_rows(label + " o", o[b], o_ref)["max_abs_err"],
                       "lse": check(label + " lse", lse[b], lse_ref, TOL_LSE)}
    del o_ref, lse_ref
    lse_f = lse[b].reshape(ROW_PLAIN_B, Sq, KVH, H // KVH).permute(0, 2, 1, 3).contiguous()
    want = ref.flash_attention_bwd_reference(ops._fold(q[b], KVH), ops._kv_fold(k[b]), ops._kv_fold(v[b]),
                                             ops._fold(o[b], KVH), lse_f, ops._fold(do[b], KVH), **kw)
    for name, got, w in (("dq", dq[b], ops._unfold(want[0])), ("dk", dk[b], want[1].permute(0, 2, 1, 3)),
                         ("dv", dv[b], want[2].permute(0, 2, 1, 3))):
        floor = TOL_GRAD_FLOOR * w.float().square().mean().sqrt().item()
        out["vs_plain"][name] = check_rows(f"{label} {name}", got.to(w.dtype), w, floor)["max_abs_err"]
    del want
    torch.cuda.empty_cache()
    return out


def row_share_timed(gen, B, Skv, H, KVH, D, causal, slices) -> dict:
    """K1, K2 and K3 on one rank's share (``H`` query heads over ``KVH`` KV
    heads on the query rows of ``slices``, each a kernel call from its first
    row, ``Skv`` KV rows), each kernel's calls timed together beside their
    bound, the plain versions (forward; backward in one call a slice) and one
    library call on the same work (F.scaled_dot_product_attention on the
    share's rows with their mask, K/V heads expanded; its backward with its
    forward subtracted); ``k123_ms`` the three kernels' sum."""
    G = H // KVH
    k, v = randn(gen, (B, Skv, KVH, D)), randn(gen, (B, Skv, KVH, D))
    kf, vf = ops._kv_fold(k), ops._kv_fold(v)
    calls = []  # each slice's own tensors, as the steps' copies give them
    for r in slices:
        q, do = randn(gen, (B, r.stop - r.start, H, D)), randn(gen, (B, r.stop - r.start, H, D))
        kw = dict(causal=causal, scale=D**-0.5, q_offset=r.start)
        qf, dof = ops._fold(q, KVH), ops._fold(do, KVH)
        o, lse = fa.flash_attention_fwd(qf, kf, vf, **kw)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        calls.append(dict(q=q, do=do, qf=qf, dof=dof, o=o, lse=lse, delta=torch.empty_like(lse), dqf=ops._fold(dq, KVH),
                          dkf=ops._kv_fold(dk), dvf=ops._kv_fold(dv), kw=kw))
    ms = {"flash_attention_fwd": gpu_ms(lambda: [fa.flash_attention_fwd(c["qf"], kf, vf, **c["kw"]) for c in calls],
                                        iters=10),
          "flash_attention_bwd_dq": gpu_ms(lambda: [fa.launch_bwd_dq(c["qf"], kf, vf, c["o"], c["dof"], c["lse"],
                                                                     c["delta"], c["dqf"], **c["kw"]) for c in calls],
                                           iters=10),
          "flash_attention_bwd_dkv": gpu_ms(lambda: [fa.launch_bwd_dkv(c["qf"], kf, vf, c["dof"], c["lse"], c["delta"],
                                                                       c["dkf"], c["dvf"], **c["kw"]) for c in calls],
                                            iters=10)}
    plain = {"fwd": gpu_ms(lambda: [ref.mha_reference_with_lse(c["q"], k, v, **c["kw"]) for c in calls],
                           iters=2, reps=3),
             "bwd": gpu_ms(lambda: [ref.flash_attention_bwd_reference(c["qf"], kf, vf, c["o"], c["lse"], c["dof"],
                                                                      **c["kw"]) for c in calls], iters=1, reps=3)}
    torch.cuda.empty_cache()
    # yardstick only: the library on the same work, the share's rows with their mask given explicitly
    q, do = (torch.cat([c[name] for c in calls], dim=1) for name in ("q", "do"))
    Sq = q.shape[1]
    mask = None
    if causal:
        positions = torch.cat([torch.arange(r.start, r.stop, device=DEV) for r in slices])
        mask = positions[:, None] >= torch.arange(Skv, device=DEV)[None, :]
    ql = q.permute(0, 2, 1, 3).detach().requires_grad_()
    kl = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).detach().requires_grad_()
    vl = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).detach().requires_grad_()
    dol = do.permute(0, 2, 1, 3)

    def lib_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), (ql, kl, vl), dol)

    lib_fwd_ms = gpu_ms(lib_fwd, iters=10)
    library = {"flash_attention_fwd": lib_fwd_ms, "backward": gpu_ms(lib_fwd_bwd, iters=5) - lib_fwd_ms}
    backend = sdpa_backend(lib_fwd_bwd)
    del ql, kl, vl
    torch.cuda.empty_cache()
    pairs = sum(live_pairs(B, H, r.stop - r.start, Skv, causal, r.start) for r in slices)
    qb, kvb, lseb = 2 * q.numel(), 2 * (k.numel() + v.numel()), 4 * B * H * Sq
    work = {"flash_attention_fwd": (4 * D * pairs, 2 * qb + kvb + lseb),  # q, k, v in; o, lse out
            "flash_attention_bwd_dkv": (8 * D * pairs, 2 * qb + 2 * kvb + 2 * lseb),  # q, do, k, v, lse, delta; dk, dv
            "flash_attention_bwd_dq": (6 * D * pairs, 4 * qb + kvb + 2 * lseb)}  # q, o, do, k, v, lse; dq, delta
    out = {"shape": f"q ({B},{KVH},{Sq},{G},{D}) k/v ({B},{KVH},{Skv},{D}) bf16 causal={causal}",
           "slices": [[r.start, r.stop] for r in slices], "library_backend": backend, "plain_ms": plain,
           "k123_ms": sum(ms.values())}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms[name], "plain_ms": plain["fwd" if name == "flash_attention_fwd" else "bwd"],
                     "library_ms": library["flash_attention_fwd" if name == "flash_attention_fwd" else "backward"],
                     "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "bound_reckoned": f"max({flops:.4g} FLOP / 989 TFLOP/s, {nbytes:.4g} B / 3.35 TB/s)"}
    return out


def phase_shards() -> dict:
    """The per-rank work of the sharded steps where ``model`` (16 ranks)
    divides the query heads but not the KV heads, one rank after another on
    this card, at full width: K1-K3 on each rank's 2 query heads and the KV
    head they read (local group 2) at granite-3-2b's (head_dim 64) and
    llama3-8b's (head_dim 128) training shapes (batch 2, seq 4096); K4 with
    its log-sum-exp on each rank's 2048 of the 32768 rows of decode_32k's
    caches (a device's 8 sequences), merged, against K4 on the whole caches,
    at kv_len that fills every shard, ends mid-shard (shards past it
    empty), ends on a shard's edge and leaves all but the first shard empty.
    Then each kernel timed on one rank's part, K4 with and without the
    log-sum-exp, and K1-K4 at llama3-8b's own shapes (head_dim 128, G 4) timed
    alone beside their bounds and the library calls. Last, where ``model``
    does not divide the query heads (``ROW_SHARE_CASES``), K1-K3 on each
    rank's ``dist.row_split`` share, built from the projections' column
    blocks as the steps build it, against the whole call (a causal share's
    two slices of the rows, the zig-zag, a call each), and ranks 0's and 1's
    shares (the two parts of a group's rows) timed as the steps run them,
    with each rank's K1 + K2 + K3 and the busier one's over their mean
    (``rows_balance``)."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    out = {"tp": SHARD_TP, "flash": {}, "decode": {}, "timed": {}}
    rows = SHARD_SEQ // SHARD_TP
    archs = [get_config(arch) for arch in (ARCH, QUICKSTART_ARCH)]
    launches0 = {name: getattr(mod, attr) for name, mod, attr in KERNEL_COUNTERS}
    for cfg in archs:
        H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        out["flash"][cfg.name] = shard_flash_case(gen, TRAIN_BATCH, TRAIN_SEQ, H, KVH, D, SHARD_TP)
        out["decode"][cfg.name] = shard_decode_case(gen, BATCH, SHARD_SEQ, H, KVH, D, SHARD_TP,
                                                    [SHARD_SEQ, 5 * rows + 77, 2 * rows, 1])
        torch.cuda.empty_cache()
    # where model does not divide the query heads: each rank's row_split share
    out["rows"], out["rows_timed"], out["rows_balance"] = {}, {}, {}
    for name, arch, B, Sq, Skv, causal in ROW_SHARE_CASES:
        cfg = get_config(arch)
        H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        theta = None if cfg.family == "encdec" else cfg.rope_theta  # whisper has no RoPE
        out["rows"][name] = row_share_case(gen, B, Sq, Skv, H, KVH, D, SHARD_TP, causal, theta)
        torch.cuda.empty_cache()
    # the checks' launches: the ranks' calls and the whole-head and whole-cache ones
    out["launches"] = {name: getattr(mod, attr) - launches0[name] for name, mod, attr in KERNEL_COUNTERS}
    for cfg in archs:
        # one rank's part: 2 query heads, their KV head; K4 on a shard's rows, with and without the lse
        H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        out["timed"][cfg.name] = {
            "flash_attention_fwd": flash_fwd_timed(gen, TRAIN_BATCH, TRAIN_SEQ, H // SHARD_TP, 1, D),
            **dict(zip(("flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                       flash_bwd_timed(gen, TRAIN_BATCH, TRAIN_SEQ, H // SHARD_TP, 1, D))),
            "decode_attention": decode_timed(gen, BATCH, rows, H, KVH, D, rows, lse=True),
        }
        torch.cuda.empty_cache()
    cfg = archs[1]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out["timed"]["d128_g4"] = {
        "flash_attention_fwd": flash_fwd_timed(gen, TRAIN_BATCH, TRAIN_SEQ, H, KVH, D),
        **dict(zip(("flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                   flash_bwd_timed(gen, TRAIN_BATCH, TRAIN_SEQ, H, KVH, D))),
        "decode_attention": decode_timed(gen, BATCH, PROMPT + NEW, H, KVH, D, PROMPT + NEW // 2),
    }
    torch.cuda.empty_cache()
    for name, arch, B, Sq, Skv, causal in ROW_SHARE_CASES:
        # ranks 0 and 1: the two parts of the first group's query rows, as the steps run them
        cfg = get_config(arch)
        H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        timed = out["rows_timed"][name] = {}
        for r in (0, 1):
            share = dist.row_split(EmulatedRank(SHARD_TP, r), H, KVH)
            kvh = len(range(KVH)[share.kv]) if isinstance(share.kv, slice) else len(share.kv)
            timed[f"rank{r}"] = row_share_timed(gen, B, Skv, share.heads.stop - share.heads.start, kvh, D, causal,
                                                share.rows(Sq, causal=causal))
        k123 = [t["k123_ms"] for t in timed.values()]
        out["rows_balance"][name] = {"k123_ms": dict(zip(timed, k123)),
                                     "busiest_over_mean": max(k123) / statistics.mean(k123)}
        torch.cuda.empty_cache()
    emit("shards", **out)
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
    return rk.flops(B, T, H), n * (K * K + 6 * K), nbytes


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
def rebound(mod, name: str, wrap):
    """Inside the block ``mod.<name>`` is ``wrap(the original)``; a rebinding
    made by this script only."""
    saved = getattr(mod, name)
    setattr(mod, name, wrap(saved))
    try:
        yield
    finally:
        setattr(mod, name, saved)


def flash_launches_per_step(record: list, times: list):
    """Inside the block every train step that ``runtime.train_step`` builds
    appends its (K1, K2, K3) launch counts to ``record`` and its (host ms,
    device ms) to ``times``: the host clock from the call to the end of its
    work on the device (the launcher waits there anyway, for the loss), the
    device's by CUDA events."""
    def wrap(saved):
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

        return build

    return rebound(train_step, "build_train_step", wrap)


def train_config(cfg):
    """Inside the block ``launch.train.run`` trains ``cfg`` whatever ``--arch``
    names (the depth-2 resume check)."""
    return rebound(train, "get_config", lambda saved: lambda arch: cfg)


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
    """Flash attention calls of one forward: one a layer, for the
    encoder-decoder one an encoder layer and two (self, cross) a decoder layer,
    and for the mamba2 hybrid one of the shared block before each group of
    ``attn_every`` layers."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    return cfg.n_layers


def forward_launches(cfg) -> int:
    """K1's launches in one training step: each attention call once, and once
    more in backward where remat runs its layer again (the hybrid's shared
    block runs outside the rematerialized layer loop)."""
    n_attn = attention_calls(cfg)
    return 2 * n_attn if cfg.remat and cfg.family != "hybrid" else n_attn


def one_step(cfg, model, plan, tol=(TOL_LOSS, TOL_GRAD_ATTN, TOL_GRAD_OTHER), batch_size=TRAIN_BATCH,
             seq=TRAIN_SEQ) -> dict:
    """One step's loss and gradients, kernels against the non-kernel path, from
    one seeded init and one batch, no optimizer. Emits its readings before it
    holds them to the limits ``tol`` (loss, attention leaves, other leaves),
    so that a failing run still shows them."""
    tol_loss, tol_attn, tol_other = tol
    L = cfg.n_layers
    n_attn = attention_calls(cfg)
    expected = (forward_launches(cfg), n_attn, n_attn)
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


# the multi-device substrate on the card (phase_mesh): train steps a variant,
# the reference's tolerances (tests/test_variants.py) against the
# single-device path, and the pipeline's microbatches and depth
MESH_STEPS, MESH_VARIANTS = 3, ("baseline", "sp", "zero")
TOL_MESH_LOGITS = 6e-2
PIPE_LAYERS, PIPE_MICRO, PIPE_SEQ = 2, 2, 512


def counted_steps(step, state, batch, n: int) -> tuple:
    """``n`` steps: their losses, (K1, K2, K3) launches and (host ms, device
    ms) each."""
    losses, launches, times = [], [], []
    for _ in range(n):
        before = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
        (state, m), host_ms, device_ms = timed(lambda: step(state, batch))
        launches.append(tuple(a - b for a, b in zip((fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count),
                                                     before)))
        losses.append(float(m["loss"]))
        times.append((host_ms, device_ms))
    return losses, launches, times


def phase_mesh(cfg) -> dict:
    """The multi-device substrate (sharding plans, sharded train and serve
    steps, EF-int8, the ring matmuls, GPipe) under NCCL at the world the
    machine gives this script: one process on card 0, a one-rank group over a
    FileStore and a 1 x 1 (data, model) mesh. It shows that the sharded code
    path launches the kernels under NCCL and computes what the single-device
    path computes; the multi-rank semantics are held on the CPU by gloo
    (tests/test_torch_mesh_ranks.py, test_torch_ring_pipeline.py,
    test_torch_compression.py).

    granite-3-2b at its training setup (full width, batch 2, seq 4096,
    remat): MESH_STEPS steps of ``build_train_step`` and of ``jit_train_step``
    for each of MESH_VARIANTS from one seeded init and batch, each loss
    within TOL_LOSS of the single-device step's and each step's (K1, K2, K3)
    launches equal to its; the median step (the steps after the first) by
    the host clock and by CUDA events beside the single-device one's. Then
    at the serving shape (batch 8, prompt 2048) one ``jit_decode_step`` for
    baseline and serve against the single-device decode at TOL_MESH_LOGITS,
    with K4's launches counted, and ``jit_prefill_step`` (baseline, K1
    counted); ``ef_int8_psum`` against the EF identity (1e-6) with NCCL's
    MAX and int32 SUM, the ring matmuls against the all-gather oracle, and
    ``pipeline_forward`` at one stage against the plain forward. Each decode
    step is timed on its second call, after a warm-up."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import ring, serve_step
    from repro_torch.runtime.pipeline import pipeline_forward
    from repro_torch.sharding import dist

    require(cfg.remat, "the full config trains under remat")
    L = cfg.n_layers
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    suite = ShapeSuite("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEV) for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}
    init = lambda: train_step.init_train_state(model, torch.Generator(device=DEV).manual_seed(0), opt_cfg, DEV)  # noqa: E731
    out = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat, "steps": MESH_STEPS}

    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", store=tdist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1,
                                 device_id=DEV)
        try:
            mesh = make_mesh_shape((1, tdist.get_world_size()), ("data", "model"), device="cuda")
            out.update(world=tdist.get_world_size(), cards_on_machine=torch.cuda.device_count(),
                       backend=tdist.get_backend(), nccl_version=".".join(map(str, torch.cuda.nccl.version())),
                       mesh={"shape": list(mesh.mesh.shape), "axes": list(mesh.mesh_dim_names)})
            want = (2 * L, L, L)
            runs = {}
            state = init()
            runs["single"] = counted_steps(train_step.build_train_step(model, make_plan(cfg, None), opt_cfg),
                                           state, batch, MESH_STEPS)
            del state
            for variant in MESH_VARIANTS:
                torch.cuda.empty_cache()
                step, st_sh, b_sh, plan = train_step.jit_train_step(model, mesh, suite, opt_cfg, variant=variant)
                state = dist.distribute(init(), st_sh)
                require(all(dist.is_dtensor(x) for x in tree_leaves(state["opt"].m)), f"{variant}: m not sharded")
                runs[variant] = counted_steps(step, state, dist.distribute(batch, b_sh), MESH_STEPS)
                del state, step
            torch.cuda.empty_cache()
            single_losses = runs["single"][0]
            train = {}
            for name, (losses, launches, times) in runs.items():
                train[name] = {"losses": losses, "launches_per_step": launches,
                               "loss_abs_err": max(abs(a - b) for a, b in zip(losses, single_losses)),
                               "median_step_ms": statistics.median(t[0] for t in times[1:]),
                               "median_step_device_ms": statistics.median(t[1] for t in times[1:]),
                               "step_ms_runs": [t[0] for t in times], "step_device_ms_runs": [t[1] for t in times]}
            for name in MESH_VARIANTS:
                train[name]["step_ms_over_single"] = train[name]["median_step_ms"] / train["single"]["median_step_ms"]
            out["train"] = train

            # ---- serving: the single-device prefill and one decode step, then the sharded ones
            B, S = BATCH, PROMPT
            params = model.init(torch.Generator(device=DEV).manual_seed(1), DEV)
            toks = torch.from_numpy(synthetic.token_batch(cfg.vocab, B, S, seed=5)["tokens"]).to(DEV)
            plan0 = make_plan(cfg, None)
            with torch.no_grad():
                fa.launch_count = 0
                last, cache = model.prefill(params, {"tokens": toks}, plan0)
                prefill_k1 = fa.launch_count
                cache = pad_cache(cache, 1)
                tok = torch.argmax(last, -1).to(torch.int32)
                one_decode = lambda: model.decode(params, {"token": tok}, cache, S, plan0)  # noqa: E731
                one_decode()  # warm-up; each call writes the same slot S
                da.launch_count = 0
                (want_logits, _), host_ms, device_ms = timed(one_decode)
                decode_k4 = da.launch_count
            serve_out = {"single": {"prefill_k1": prefill_k1, "decode_k4": decode_k4, "decode_ms": host_ms,
                                    "decode_device_ms": device_ms}}
            for variant in ("baseline", "serve"):
                dstep, p_sh, tok_sh, c_sh, _ = serve_step.jit_decode_step(model, mesh, ShapeSuite("d", S + 1, B, "decode"),
                                                                          variant=variant)
                args = (dist.distribute(params, p_sh), dist.distribute({"token": tok}, tok_sh),
                        dist.distribute({k: v.clone() for k, v in cache.items()}, c_sh))
                dstep(*args)  # warm-up (DTensor's sharding rules are cached at first use)
                da.launch_count = 0
                (logits, _), host_ms, device_ms = timed(lambda: dstep(*args))
                serve_out[variant] = {"decode_k4": da.launch_count, "decode_ms": host_ms, "decode_device_ms": device_ms,
                                      "decode_ms_over_single": host_ms / serve_out["single"]["decode_ms"],
                                      "logits_max_abs_err": max_err(logits.full_tensor(), want_logits)}
                del args
            pstep, p_sh, b_sh, _ = serve_step.jit_prefill_step(model, mesh, ShapeSuite("p", S, B, "prefill"))
            fa.launch_count = 0
            got_last, _ = pstep(dist.distribute(params, p_sh), dist.distribute({"tokens": toks}, b_sh))
            serve_out["baseline"].update(prefill_k1=fa.launch_count,
                                         prefill_logits_max_abs_err=max_err(got_last.full_tensor(), last))
            out["serve"] = serve_out
            del params, cache, last, got_last
            torch.cuda.empty_cache()

            # ---- EF-int8 under NCCL (MAX of the scale, int32 SUM), the ring matmuls, GPipe at one stage
            gen = torch.Generator(device=DEV).manual_seed(2)
            grads = {"w": torch.randn(2048, 2048, generator=gen, device=DEV) * 0.01,
                     "b": torch.randn(8192, generator=gen, device=DEV)}
            err0 = compression.init_error_state(grads)
            mean, err = compression.ef_int8_psum(grads, err0)
            ef = max(max_err(mean[k] + err[k], grads[k]) for k in grads)
            x, w = torch.randn(64, 2048, generator=gen, device=DEV), torch.randn(2048, 512, generator=gen, device=DEV)
            ring_err = max(max_err(ring.ring_ag_matmul(x, w), x @ w),
                           max_err(ring.ring_rs_matmul(x @ w, w.t().contiguous()), (x @ w) @ w.t()))
            pcfg = dataclasses.replace(cfg, n_layers=PIPE_LAYERS)
            pparams = build_model(pcfg).init(torch.Generator(device=DEV).manual_seed(3), DEV)
            ptoks = torch.from_numpy(synthetic.token_batch(cfg.vocab, PIPE_MICRO * 2, PIPE_SEQ, seed=6)["tokens"]).to(DEV)
            fa.launch_count = 0
            plog = pipeline_forward(pcfg, pparams, ptoks.reshape(PIPE_MICRO, 2, PIPE_SEQ),
                                    make_mesh_shape((1,), ("stage",), device="cuda"))
            pipe_k1 = fa.launch_count
            with torch.no_grad():
                pwant = transformer.forward(pcfg, pparams, ptoks, plan0).float()
            pipe_err = max_err(plog.reshape(pwant.shape), pwant)
            out["collectives"] = {"ef_int8_identity_max_abs_err": ef, "ef_tolerance": 1e-6,
                                  "ring_vs_all_gather_max_abs_err": ring_err,
                                  "pipeline_vs_plain_max_abs_err": pipe_err, "pipeline_k1": pipe_k1,
                                  "pipeline": {"stages": 1, "microbatches": PIPE_MICRO, "layers": PIPE_LAYERS,
                                               "seq": PIPE_SEQ}}
            del pparams, grads, mean, err, err0
        finally:
            tdist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("mesh", **out)
    for name, rec in out["train"].items():
        require(all(c == want for c in rec["launches_per_step"]),
                f"{name}: per-step (K1, K2, K3) launches {rec['launches_per_step']}, the single device's {want}")
        require(rec["loss_abs_err"] <= TOL_LOSS, f"{name}: losses {rec['losses']} vs single {single_losses}")
    for variant in ("baseline", "serve"):
        rec = serve_out[variant]
        require(rec["decode_k4"] == decode_k4 == L, f"{variant}: K4 launches {rec['decode_k4']}, single {decode_k4}")
        require(rec["logits_max_abs_err"] <= TOL_MESH_LOGITS, f"{variant} decode logits: {rec}")
    require(serve_out["baseline"]["prefill_k1"] == prefill_k1 == L, f"prefill K1 launches {serve_out}")
    require(serve_out["baseline"]["prefill_logits_max_abs_err"] <= TOL_MESH_LOGITS, f"prefill logits: {serve_out}")
    require(ef <= 1e-6, f"EF-int8: mean + residual off the input by {ef}")
    require(ring_err <= 1e-2, f"ring matmuls off the all-gather oracle by {ring_err}")
    require(pipe_err <= TOL_MESH_LOGITS and pipe_k1 == PIPE_LAYERS * PIPE_MICRO, f"pipeline: {out['collectives']}")
    return out


# the new families' sharded steps at world 1 (phase_mesh_families): the
# steps a train run takes (the first one warms up), llava-next-34b's depth,
# deepseek-moe-16b's serving depth
MESH_FAMILY_STEPS, LLAVA_ARCH, LLAVA_MESH_LAYERS, DEEPSEEK_MESH_LAYERS = 2, "llava-next-34b", 2, 2


@contextlib.contextmanager
def mesh_world_1():
    """A one-rank NCCL group on card 0 over a FileStore, and its 1 x 1
    (data, model) mesh, for the block."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_shape

    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", store=tdist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1,
                                 device_id=DEV)
        try:
            yield make_mesh_shape((1, 1), ("data", "model"), device="cuda")
        finally:
            tdist.destroy_process_group()


def routes_of(cfg):
    """``routes_recorded`` for the MoE family; for the others a block that
    records and replays nothing."""
    return routes_recorded if cfg.family == "moe" else (lambda record, replay=None: contextlib.nullcontext())


def mesh_family_train(cfg, mesh, batch_size: int, seq: int) -> dict:
    """MESH_FAMILY_STEPS steps of ``build_train_step`` and of ``jit_train_step``
    (baseline, sp) from one seeded init and batch: the losses, each step's
    (K1, K2, K3) launches and its times. The MoE family's sharded steps route
    by the single device's choices (``routes_recorded``)."""
    from repro_torch.optim import adamw

    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    suite = ShapeSuite("train_4k", seq, batch_size, "train")
    batch = from_jax_params(synthetic.batch_for(cfg, suite, seed=0), DEV)
    init = lambda: train_step.init_train_state(model, torch.Generator(device=DEV).manual_seed(0), opt_cfg, DEV)  # noqa: E731
    routed = routes_of(cfg)
    routes: list = []
    with routed(routes):
        runs = {"single": counted_steps(train_step.build_train_step(model, make_plan(cfg, None), opt_cfg), init(),
                                        batch, MESH_FAMILY_STEPS)}
    torch.cuda.empty_cache()
    for variant in ("baseline", "sp"):
        step, st_sh, b_sh, _ = train_step.jit_train_step(model, mesh, suite, opt_cfg, variant=variant)
        with routed([], routes):
            runs[variant] = counted_steps(step, dist.distribute(init(), st_sh), dist.distribute(batch, b_sh),
                                          MESH_FAMILY_STEPS)
        del step
        torch.cuda.empty_cache()
    single = runs["single"]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch_size, "seq": seq, "remat": cfg.remat,
           "routing_replayed": cfg.family == "moe"}
    for name, (losses, launches, times) in runs.items():
        out[name] = {"losses": losses, "launches_per_step": launches,
                     "loss_abs_err": max(abs(a - b) for a, b in zip(losses, single[0])),
                     "step_ms": times[-1][0], "step_device_ms": times[-1][1]}
    for name in ("baseline", "sp"):
        out[name]["step_ms_over_single"] = out[name]["step_ms"] / out["single"]["step_ms"]
    return out


def mesh_family_serve(cfg, mesh, prompt: int) -> dict:
    """The single-device prefill and one decode step (its second call), then
    ``jit_prefill_step`` and ``jit_decode_step`` (baseline, serve) on the same
    requests: the logits against the single device's, K1's launches in the
    prefill and K4's in the decode step, the decode step's times."""
    from repro_torch.runtime import serve_step

    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(1), DEV)
    batch = from_jax_params(synthetic.batch_for(cfg, ShapeSuite("p", prompt, BATCH, "prefill"), seed=5), DEV)
    batch.pop("labels", None)
    plan0 = make_plan(cfg, None)
    routed = routes_of(cfg)
    prefill_routes: list = []
    decode_routes: list = []
    with torch.no_grad():
        fa.launch_count = rk.launch_count = 0
        with routed(prefill_routes):
            last, cache = model.prefill(params, batch, plan0)
        prefill_k1, prefill_k5 = fa.launch_count, rk.launch_count
        cache = pad_cache(cache, 1)
        tok = torch.argmax(last, -1).to(torch.int32)
        # each decode call on a copy of the prefill's cache: a K/V write
        # rewrites one slot, but a recurrent state advances at every call
        fresh = lambda: {k: v.clone() for k, v in cache.items()}  # noqa: E731
        with routed(decode_routes):
            model.decode(params, {"token": tok}, fresh(), prompt, plan0)  # warm-up
            c = fresh()
            da.launch_count = 0
            (want, _), host_ms, device_ms = timed(lambda: model.decode(params, {"token": tok}, c, prompt, plan0))
        decode_k4 = da.launch_count
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": BATCH, "prompt": prompt,
           "routing_replayed": cfg.family == "moe",
           "single": {"prefill_k1": prefill_k1, "prefill_k5": prefill_k5, "decode_k4": decode_k4,
                      "decode_ms": host_ms, "decode_device_ms": device_ms}}
    for variant in ("baseline", "serve"):
        pstep, p_sh, b_sh, _ = serve_step.jit_prefill_step(model, mesh, ShapeSuite("p", prompt, BATCH, "prefill"),
                                                           variant=variant)
        fa.launch_count = rk.launch_count = 0
        with routed([], prefill_routes):
            got_last, _ = pstep(dist.distribute(params, p_sh), dist.distribute(batch, b_sh))
        k1, k5 = fa.launch_count, rk.launch_count
        dstep, p_sh, tok_sh, c_sh, _ = serve_step.jit_decode_step(
            model, mesh, ShapeSuite("d", prompt + 1, BATCH, "decode"), variant=variant)
        args = (dist.distribute(params, p_sh), dist.distribute({"token": tok}, tok_sh))
        with routed([], decode_routes):
            dstep(*args, dist.distribute(fresh(), c_sh))  # warm-up (DTensor's sharding rules are cached at first use)
            c = dist.distribute(fresh(), c_sh)
            da.launch_count = 0
            (logits, _), d_host_ms, d_device_ms = timed(lambda: dstep(*args, c))
        out[variant] = {"prefill_k1": k1, "prefill_k5": k5, "decode_k4": da.launch_count,
                        "prefill_logits_max_abs_err": max_err(got_last.full_tensor(), last),
                        "decode_logits_max_abs_err": max_err(logits.full_tensor(), want),
                        "decode_ms": d_host_ms, "decode_device_ms": d_device_ms,
                        "decode_ms_over_single": d_host_ms / host_ms}
        del args, c, got_last, logits
        torch.cuda.empty_cache()
    del params, cache
    torch.cuda.empty_cache()
    return out


def phase_mesh_families() -> dict:
    """phase_mesh for the vlm, moe and encdec families, under NCCL at world 1
    (one process on card 0, a 1 x 1 mesh), each sharded step held against
    its single-device step from one seeded init and batch: training
    (baseline, sp) of llava-next-34b at full width and LLAVA_MESH_LAYERS
    layers, olmoe-1b-7b at full width and OLMOE_TRAIN_LAYERS (routing
    replayed) and whisper-base at full size, losses within TOL_LOSS;
    prefill and decode (baseline, serve) of deepseek-moe-16b at
    DEEPSEEK_MESH_LAYERS layers (routing replayed) and whisper-base, logits
    within TOL_MESH_LOGITS. Every sharded step launches K1-K3 (training), K1
    (prefill) and K4 (decode) as often as the single device's."""
    out = {"train": {}, "serve": {}}
    with mesh_world_1() as mesh:
        for c, b, seq in ((dataclasses.replace(get_config(LLAVA_ARCH), n_layers=LLAVA_MESH_LAYERS), TRAIN_BATCH,
                           TRAIN_SEQ),
                          (olmoe_train_config(), TRAIN_BATCH, TRAIN_SEQ),
                          (get_config(WHISPER_ARCH), BATCH, WHISPER_PROMPT + NEW)):
            out["train"][c.name] = mesh_family_train(c, mesh, b, seq)
            torch.cuda.empty_cache()
        for c, prompt in ((dataclasses.replace(get_config(DEEPSEEK_ARCH), n_layers=DEEPSEEK_MESH_LAYERS), PROMPT),
                          (get_config(WHISPER_ARCH), WHISPER_PROMPT)):
            out["serve"][c.name] = mesh_family_serve(c, mesh, prompt)
    emit("mesh_families", **out)
    for arch, rec in out["train"].items():
        want = rec["single"]["launches_per_step"]
        for variant in ("baseline", "sp"):
            require(rec[variant]["launches_per_step"] == want,
                    f"{arch} {variant}: (K1, K2, K3) a step {rec[variant]['launches_per_step']}, single {want}")
            require(rec[variant]["loss_abs_err"] <= TOL_LOSS, f"{arch} {variant}: {rec[variant]} vs {rec['single']}")
    require_mesh_serve(out["serve"])
    return out


def require_mesh_serve(served: dict) -> None:
    """Each sharded prefill and decode step launched K1, K5 (prefill) and K4
    (decode) as often as the single device's, its logits within TOL_MESH_LOGITS."""
    for arch, rec in served.items():
        want = tuple(rec["single"][k] for k in ("prefill_k1", "prefill_k5", "decode_k4"))
        for variant in ("baseline", "serve"):
            r = rec[variant]
            require(tuple(r[k] for k in ("prefill_k1", "prefill_k5", "decode_k4")) == want,
                    f"{arch} {variant}: (K1, K5 prefill, K4 decode) launches {r}, single {rec['single']}")
            require(max(r["prefill_logits_max_abs_err"], r["decode_logits_max_abs_err"]) <= TOL_MESH_LOGITS,
                    f"{arch} {variant} logits: {r}")


# the recurrent families and ResNet under the sharded steps
# (phase_mesh_recurrent): zamba2-7b served at full width and
# ZAMBA_MESH_LAYERS layers in groups of ZAMBA_MESH_EVERY (two applications of
# the shared attention block), and a sharded rwkv6-1.6b train step on the
# card (RWKV_TRAIN_RAISES: layers, batch, seq), which must raise
ZAMBA_MESH_LAYERS, ZAMBA_MESH_EVERY = 6, 3
RWKV_TRAIN_RAISES = (1, 2, 256)


def mesh_resnet_train(arch, mesh) -> dict:
    """One step of ``arch`` at full size and batch RESNET_BATCH (f32, TF32
    off, as the launcher runs it), ``build_train_step`` and ``jit_train_step``
    (baseline, sp) from one seeded init and batch: the loss's relative error
    and the largest relative L2 error of a leaf of AdamW's first moment (the
    clipped gradient, scaled) against the single device's; and each run's
    first moment, brought to the gradient's global norm, against the same
    step's gradient on the CPU in float64 (the trio's yardstick)."""
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    batch = resnet_batch(cfg, DEV)
    suite = ShapeSuite("paper", cfg.img_size**2, RESNET_BATCH, "train")
    init = lambda: train_step.init_train_state(model, torch.Generator(device=DEV).manual_seed(0), opt_cfg, DEV)  # noqa: E731
    names = ["/".join(path) for path, _ in tree_paths(model.init(torch.Generator(device="cpu"), "meta"))]
    params64 = tree_map(lambda x: x.detach().cpu().double(), init()["params"])
    loss64, grads64 = resnet_grads(model, params64, {"images": batch["images"].cpu().double(),
                                                     "labels": batch["labels"].cpu()})
    norm64 = torch.stack([g.square().sum() for g in grads64]).sum().sqrt()

    def vs_float64(moments) -> dict:
        scale = norm64 / torch.stack([dist.full(m).double().cpu().square().sum() for m in moments]).sum().sqrt()
        errs = {n: rel_l2(dist.full(m).double().cpu() * scale, g)[0] for n, m, g in zip(names, moments, grads64)}
        worst = max(errs, key=errs.get)
        return {"moment_vs_float64_rel_l2_max": errs[worst], "moment_vs_float64_worst_leaf": worst}

    out = {"arch": arch, "batch": RESNET_BATCH, "loss_float64": loss64.item()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        (state, m), host_ms, _ = timed(lambda: train_step.build_train_step(model, make_plan(cfg, None), opt_cfg)(
            init(), batch))
        loss, moments = float(m["loss"]), [x.detach().clone() for x in tree_leaves(state["opt"].m)]
        out["single"] = dict(loss=loss, step_ms=host_ms, **vs_float64(moments))
        del state
        for variant in ("baseline", "sp"):
            step, st_sh, b_sh, _ = train_step.jit_train_step(model, mesh, suite, opt_cfg, variant=variant)
            (state, m), host_ms, _ = timed(lambda: step(dist.distribute(init(), st_sh), dist.distribute(batch, b_sh)))
            got = list(tree_leaves(state["opt"].m))
            errs = {n: rel_l2(dist.full(g), w)[0] for n, g, w in zip(names, got, moments)}
            worst = max(errs, key=errs.get)
            out[variant] = dict(loss=float(m["loss"]), loss_rel_err=abs(float(m["loss"]) - loss) / abs(loss),
                                moment_rel_l2_max=errs[worst], moment_rel_l2_worst_leaf=worst, step_ms=host_ms,
                                **vs_float64(got))
            del state, step, got
    torch.cuda.empty_cache()
    return out


def mesh_rwkv_train_raises(mesh) -> dict:
    """A sharded rwkv6 train step (full width, RWKV_TRAIN_RAISES) on the card:
    K5 has no backward (nor has the reference's kernel), so the step raises
    at its first scan, launching nothing, rather than scanning some other way."""
    from repro_torch.optim import adamw

    layers, batch_size, seq = RWKV_TRAIN_RAISES
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=layers)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    suite = ShapeSuite("t", seq, batch_size, "train")
    step, st_sh, b_sh, _ = train_step.jit_train_step(model, mesh, suite, opt_cfg)
    state = dist.distribute(train_step.init_train_state(model, torch.Generator(device=DEV).manual_seed(0), opt_cfg,
                                                        DEV), st_sh)
    batch = dist.distribute(from_jax_params(synthetic.batch_for(cfg, suite, seed=0), DEV), b_sh)
    rk.launch_count = 0
    try:
        step(state, batch)
        error = None
    except NotImplementedError as e:
        error = str(e)
    del state, batch, step
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "batch": batch_size, "seq": seq, "raised": error,
            "k5_launches": rk.launch_count}


def phase_mesh_recurrent() -> dict:
    """phase_mesh for the hybrid, rwkv and resnet families, under NCCL at
    world 1 (one process on card 0, a 1 x 1 mesh), each sharded step held
    against its single-device step from one seeded init and batch: zamba2-7b
    training (baseline, sp) at full width and depth ZAMBA_TRAIN_LAYERS (K1-K3,
    losses within TOL_LOSS); zamba2-7b at full width and ZAMBA_MESH_LAYERS
    layers and rwkv6-1.6b at full size served (baseline, serve; K1 and K5 in
    the prefill, K4 in the decode step, logits within TOL_MESH_LOGITS);
    resnet_small training (baseline, sp; the trio's limits, TOL_RESNET_LOSS
    and TOL_RESNET_GRAD); and a sharded rwkv6 train step, which must raise
    K5's "no backward" error. Launches equal the single device's."""
    out = {"train": {}, "serve": {}}
    with mesh_world_1() as mesh:
        zamba = zamba_train_config()
        out["train"][zamba.name] = mesh_family_train(zamba, mesh, TRAIN_BATCH, TRAIN_SEQ)
        torch.cuda.empty_cache()
        for c in (dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_MESH_LAYERS, attn_every=ZAMBA_MESH_EVERY),
                  get_config(RWKV_ARCH)):
            out["serve"][c.name] = mesh_family_serve(c, mesh, PROMPT)
            torch.cuda.empty_cache()
        out["resnet"] = mesh_resnet_train(RESNET_ARCHS[0], mesh)
        out["rwkv_train"] = mesh_rwkv_train_raises(mesh)
    emit("mesh_recurrent", **out)
    for arch, rec in out["train"].items():
        want = rec["single"]["launches_per_step"]
        for variant in ("baseline", "sp"):
            require(rec[variant]["launches_per_step"] == want,
                    f"{arch} {variant}: (K1, K2, K3) a step {rec[variant]['launches_per_step']}, single {want}")
            require(rec[variant]["loss_abs_err"] <= TOL_LOSS, f"{arch} {variant}: {rec[variant]} vs {rec['single']}")
    require_mesh_serve(out["serve"])
    rwkv_k5 = out["serve"][RWKV_ARCH]["baseline"]["prefill_k5"]
    require(rwkv_k5 == get_config(RWKV_ARCH).n_layers, f"rwkv6's sharded prefill launched K5 {rwkv_k5} times")
    for variant in ("baseline", "sp"):
        r = out["resnet"][variant]
        require(r["loss_rel_err"] <= TOL_RESNET_LOSS and r["moment_rel_l2_max"] <= TOL_RESNET_GRAD
                and r["moment_vs_float64_rel_l2_max"] <= TOL_RESNET_GRAD,
                f"resnet {variant}: {r} vs {out['resnet']['single']}")
    r = out["rwkv_train"]
    require(r["raised"] is not None and "no backward" in r["raised"] and r["k5_launches"] == 0,
            f"a sharded rwkv6 train step on the card did not raise K5's error: {r}")
    return out


# the dry-run (phase_dryrun): two cells of ``python -m repro_torch.launch.dryrun``
# on fake process groups of 256 and 512 ranks, then granite's training step
# lowered at a fake 1 x 1 mesh against the same step on the card
DRYRUN_CELLS = (("granite-3-2b", "train_4k", "single"), ("deepseek-moe-16b", "decode_32k", "multi"))
DRYRUN_TIMEOUT_S = 300
DRYRUN_CHILD = """
import json, sys
from repro_torch.configs.base import ShapeSuite
from repro_torch.launch.lowering import fake_world, lower_cell
from repro_torch.launch.mesh import make_mesh_shape
arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with fake_world(1):
    _, _, low = lower_cell(arch, ShapeSuite("train_4k", seq, batch, "train"),
                           make_mesh_shape((1, 1), ("data", "model"), device="cpu"))
print(json.dumps({"fingerprint": low.fingerprint, "flops": low.flops, "bytes": low.bytes, "memory": low.memory}))
"""


@contextlib.contextmanager
def flash_kernels_plain():
    """Inside the block the flash kernels' wrappers run their plain versions
    on the card's tensors: the ops they run for a CPU tensor, which the
    dry-run traces. A rebinding made by this script only."""
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(q, k, v, *, causal, scale, q_offset=0, out=None):
        return fa.plain_fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset)

    def bwd(q, k, v, o, lse, do, *, causal, scale, q_offset=0):
        return ref.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, scale=scale, q_offset=q_offset)

    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved


def phase_dryrun(cfg) -> dict:
    """The multi-pod dry-run, in processes of its own (a fake process group
    cannot share this one with an NCCL group): ``python -m
    repro_torch.launch.dryrun`` for each of DRYRUN_CELLS, every one OK, its
    roofline terms, bound, GiB a device and ``t_lower_s`` printed. Then
    granite-3-2b's training step at phase train's setup (batch 2, seq 4096,
    remat) lowered at a fake 1 x 1 mesh (``lower_cell``), against the same
    step run on the card at world 1 (NCCL, a 1 x 1 mesh) on the non-kernel
    path under the counters (``count_step``): its fingerprint and FLOPs must
    be equal. The predicted peak a device is printed beside the kernel
    path's ``max_memory_allocated`` over one more step, as a ratio, and not
    held: the lowering's attention is the plain version's, which holds the
    score matrix."""
    from repro_torch.optim import adamw
    from repro_torch.telemetry.counts import count_step

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    cells = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, mesh_kind in DRYRUN_CELLS:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                                   "--mesh", mesh_kind, "--out", tmp], env=env, capture_output=True, text=True,
                                  timeout=DRYRUN_TIMEOUT_S)
            label = f"{arch}__{shape}__{mesh_kind}"
            require(proc.returncode == 0, f"dryrun {label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            rec = json.loads(Path(tmp, f"{label}.json").read_text())
            require(rec["status"] == "OK", f"dryrun {label}: {rec}")
            r = rec["roofline"]
            cells[label] = {"compute_s": r["compute_s"], "memory_s": r["memory_s"], "collective_s": r["collective_s"],
                            "bound": r["bound"], "step_s": r["step_s"], "mesh": r["mesh"], "chips": r["chips"],
                            "gib_per_device": r["peak_mem_bytes_per_device"] / 2**30,
                            "flops_per_device": r["flops_per_device"], "hbm_bytes_per_device": r["hbm_bytes_per_device"],
                            "wire_bytes_per_device": r["wire_bytes_per_device"], "t_lower_s": rec["t_lower_s"],
                            "process_wall_s": time.perf_counter() - t0, "line": proc.stdout.strip()}
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", DRYRUN_CHILD, cfg.name, str(TRAIN_SEQ), str(TRAIN_BATCH)],
                               env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        require(child.returncode == 0, f"lower_cell at 1 x 1: exit {child.returncode}\n{child.stderr[-3000:]}")
        lowered = json.loads(child.stdout.strip().splitlines()[-1])
        lower_s = time.perf_counter() - t0

    require(cfg.remat, "the full config trains under remat")
    suite = ShapeSuite("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    model, opt_cfg = build_model(cfg), adamw.AdamWConfig()
    with mesh_world_1() as mesh:
        step, st_sh, b_sh, _ = train_step.jit_train_step(model, mesh, suite, opt_cfg)
        state = dist.distribute(train_step.init_train_state(model, torch.Generator(device=DEV).manual_seed(0),
                                                            opt_cfg, DEV), st_sh)
        batch = dist.distribute({k: torch.from_numpy(np.asarray(v)).to(DEV)
                                 for k, v in synthetic.batch_for(cfg, suite, seed=0).items()}, b_sh)
        fa.launch_count = fa.dkv_launch_count = fa.dq_launch_count = 0
        with flash_kernels_plain():
            _, counts = count_step(lambda: step(state, batch), inputs=(state, batch))
        plain_launches = (fa.launch_count, fa.dkv_launch_count, fa.dq_launch_count)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        kernel_peak = torch.cuda.max_memory_allocated()
        del state, batch, step
    torch.cuda.empty_cache()
    predicted = lowered["memory"]["peak_bytes_per_device"]
    out = {"cells": cells,
           "one_device": {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
                          "lowered_fingerprint": lowered["fingerprint"], "card_fingerprint": counts.fingerprint,
                          "lowered_flops": lowered["flops"], "card_flops": counts.flops,
                          "lowered_hbm_bytes": lowered["bytes"], "card_hbm_bytes": counts.hbm_bytes,
                          "lower_process_wall_s": lower_s, "card_plain_launches": plain_launches,
                          "predicted_peak_gib": predicted / 2**30, "memory": lowered["memory"],
                          "kernel_path_max_allocated_gib": kernel_peak / 2**30,
                          "predicted_over_kernel_path": predicted / kernel_peak,
                          "peak_not_held": "the lowering's attention is the plain version's, which holds the "
                                           "score matrix; the kernels never do"}}
    emit("dryrun", **out)
    one = out["one_device"]
    require(plain_launches == (0, 0, 0), f"the non-kernel step launched {plain_launches}")
    require(one["lowered_fingerprint"] == one["card_fingerprint"] and one["lowered_flops"] == one["card_flops"],
            f"the dry-run's 1 x 1 program is not the card's: {one}")
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
    those experts, renormalized as ``top_k_gates`` does (a sharded step's
    call at world 1 gets them as a DTensor of its ids' placements). A
    rebinding made by this script only, as ``torch_attention_path`` is."""
    saved = moe.top_k_gates
    replayed = iter(replay) if replay is not None else None

    def recording(probs, k, renormalize=True):
        vals, idx = saved(probs, k, renormalize)
        record.append(dist.full(idx))
        if replayed is None:
            return vals, idx
        forced = next(replayed)
        if dist.is_dtensor(idx):  # a sharded step at world 1: the whole ids are the one shard
            forced = dist.from_local(forced, idx.device_mesh, idx.placements)
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

    with attention_rebound(bracketed("flash_attention_fwd", attention.flash_attention),
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
    saved = attention.flash_attention, transformer.decode_attention
    for name in ("flash_attention_fwd", "decode_attention"):
        records.setdefault(name, [])

    def flash(q, k, v, *, causal=True, block_k=1024, q_offset=0, scale=None, kv_len=None):
        out = saved[0](q, k, v, causal=causal, block_k=block_k, q_offset=q_offset, scale=scale, kv_len=kv_len)
        want = ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
        records["flash_attention_fwd"].append(rows_within(out.reshape(want.shape), want))  # rows of one head, as K1 holds them
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
                  "on the card's peaks (f32 67 TFLOP/s, 3.35 TB/s); bytes by telemetry/hlo.py, the reference's "
                  "fused traffic model")
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


KERNEL_COUNTERS = (("flash_attention_fwd", fa, "launch_count"), ("flash_attention_bwd_dkv", fa, "dkv_launch_count"),
                   ("flash_attention_bwd_dq", fa, "dq_launch_count"), ("decode_attention", da, "launch_count"),
                   ("wkv6_scan", rk, "launch_count"))


def launch_counts() -> dict:
    """K1-K5's launch counters, by the names their wrappers report to the op counters."""
    return {name: getattr(mod, attr) for name, mod, attr in KERNEL_COUNTERS}


def reset_launch_counts() -> None:
    for _, mod, attr in KERNEL_COUNTERS:
        setattr(mod, attr, 0)


@contextlib.contextmanager
def counted_steps_recorded(record: list):
    """Inside the block every step that ``telemetry.counts.count_step`` counts
    (``measure_job``'s counted step) appends (the launch counters' deltas
    across it, its kernel entries, its counted FLOPs) to ``record``: the two
    ways of seeing the kernels, side by side. A rebinding made by this script
    only."""
    saved = counts.count_step

    def counting(fn, inputs):
        before = launch_counts()
        out, c = saved(fn, inputs)
        after = launch_counts()
        record.append(({k: after[k] - before[k] for k in after}, dict(c.kernels), c.flops))
        return out, c

    counts.count_step = counting
    try:
        yield
    finally:
        counts.count_step = saved


def require_entries(what: str, counted: tuple, want: dict) -> None:
    """One counted step's launches, by the counters and by its kernel entries,
    both ``want`` ({name: launches}, the rest 0)."""
    deltas, entries, _ = counted
    by_entries = {name: entries.get(name, (0, 0.0))[0] for name in deltas}
    expected = {name: want.get(name, 0) for name in deltas}
    require(deltas == expected and by_entries == expected,
            f"{what}: launches {deltas}, kernel entries {by_entries}, expected {expected}")


def phase_collocate_lm(cfg, trained: dict, served: dict) -> dict:
    """The LM workloads of the characterization, on the card, in this process.

    (a) granite-3-2b at full width and TRAIN_SEQ, global batch
    COLLOCATE_LM_BATCH (g micro batches of LM_MICRO_BATCH a step) through
    ``collocate.characterize_workload`` over every cell of the grid: every
    cell OK and measured, the counted step's K1/K2/K3 entries equal to the
    launch counters across it, g x (2L, L, L), their FLOPs 22·D·live
    pairs·L·g, every launch of the phase in whole steps; readings: the count
    over the reckoning 8·N·tokens + 22·D·pairs·L·g, the solo step over g x
    phase_train's median (within SOLO_LIMIT), tokens/s, the peak and the MIG
    profiles it fits, F2's speedup of 1g.10gb parallel over 7g.80gb.
    (b) granite's prefill at (BATCH, PROMPT) and decode step at (BATCH,
    PROMPT + NEW) through ``InstanceRuntime.characterize`` on the whole card:
    each step within SOLO_LIMIT of phase_serve's median, K1 L a prefill and K4
    L a decode step by entries and by counters. (c) COLLOCATE_LM_SKIPPED is
    skipped with its reckoned state, the card's allocation unchanged."""
    t0 = time.perf_counter()
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    g = COLLOCATE_LM_BATCH // collocate.LM_MICRO_BATCH
    suite = ShapeSuite("train_4k", TRAIN_SEQ, COLLOCATE_LM_BATCH, "train")
    sku = get_sku(collocate.SKU)
    measurements, counted = {}, []
    whole = (max(1, -(-instance.WARMUP_STEPS // g)) + max(1, -(-instance.TIMED_STEPS // g)) + 1)
    per_step = {"flash_attention_fwd": 2 * L * g, "flash_attention_bwd_dkv": L * g, "flash_attention_bwd_dq": L * g}

    # ---- (a) the accumulated train step over the grid
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp, counted_steps_recorded(counted):
        done = collocate.characterize_workload(ARCH, cfg, suite, collocate.LM_SAMPLES, DEV, Path(tmp), measurements,
                                               grad_accum=g)
        cells = {c["group"]: c for c in done["cells"]}
    train_launches = launch_counts()
    train_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    m = measurements[(ARCH, suite, g)]
    pairs = live_pairs(collocate.LM_MICRO_BATCH, H, TRAIN_SEQ, TRAIN_SEQ, True)
    kernel_flops = 22 * D * pairs * L * g
    tokens = COLLOCATE_LM_BATCH * TRAIN_SEQ
    leaves = list(tree_leaves(build_model(cfg).init(torch.Generator(device="cpu"), "meta")))
    n_params = sum(p.numel() for p in leaves)
    # the products' weights (the f32 norm scales are none) and the tied
    # embedding, which the head multiplies forward and backward only (6 a
    # parameter and token); checkpoint's recompute of a layer stops once what
    # backward needs is rebuilt, so the last product, the MLP's down
    # projection (2 d f a token), runs twice, not three times
    n_matmul = sum(p.numel() for p in leaves if p.dtype == torch.bfloat16)
    n_embed = cfg.vocab * cfg.d_model
    exact = tokens * (8 * (n_matmul - n_embed) - 2 * cfg.d_model * cfg.d_ff * L + 6 * n_embed)
    solo = cells["non-MIG"]["records"][0]
    full_one = InstanceRecord(**cells[f"{sku.full_profile} one"]["records"][0])
    par = [InstanceRecord(**r) for r in cells[f"{sku.profile_order[0]} parallel"]["records"]]
    out = {
        "arch": cfg.name, "seq": TRAIN_SEQ, "global_batch": COLLOCATE_LM_BATCH, "grad_accum": g,
        "cells": len(done["cells"]), "failures": done["failures"], "whole_steps": whole,
        "launches": train_launches, "counted_step": {"launches": counted[0][0] if counted else None,
                                                     "entries": counted[0][1] if counted else None},
        "kernel_flops": {k: f for k, (_, f) in m.kernels.items()}, "kernel_flops_reckoned": kernel_flops,
        "counted_flops": m.flops, "reckoned_flops": 8 * n_params * tokens + kernel_flops,
        "counted_over_reckoned": m.flops / (8 * n_params * tokens + kernel_flops),
        "kernel_share_of_counted_flops": kernel_flops / m.flops,
        "counted_over_exact": m.flops / (exact + kernel_flops),
        "exact_reckoned": "tokens (8 (bf16 weights - tied embedding) - 2 d_ff d L + 6 tied embedding) + the kernels'",
        "solo_step_ms": solo["step_s"] * 1e3, "phase_train_median_step_device_ms": trained["median_step_device_ms"],
        "solo_over_g_train_steps": solo["step_s"] * 1e3 / (g * trained["median_step_device_ms"]),
        "tokens_per_s": tokens / solo["step_s"], "peak_bytes": m.peak_bytes,
        "mig_profiles_fitting": sorted({grp.split()[0] for grp, c in cells.items()
                                        if grp.endswith(" one") and c["records"][0]["fits"]}),
        "compute_ms": solo["compute_s"] * 1e3, "memory_ms": solo["memory_s"] * 1e3, "bound": solo["bound"],
        f"collocation_speedup_{sku.profile_order[0]}_parallel_vs_{sku.full_profile}": collocation_speedup(par, full_one),
        "wall_s": train_s,
        "reckoned": "8 N tokens (forward, backward, remat's second forward) + 22 D live pairs L g "
                    "(K1 4 D twice a layer, K2 8 D, K3 6 D)",
    }
    emit("collocate_lm", **out)
    require(done["failures"] == 0 and done["skipped"] is None, f"granite's LM characterization: {done['failures']} "
            f"failed, skipped {done['skipped']}")
    n_cells = len(collocate.paper_experiment_grid([ARCH], suite, sku=sku)) + 2 * len(collocate.SHARED_KS)
    require(len(cells) == n_cells and all(c["status"] == "OK" and c["measured"] for c in done["cells"]),
            f"{len(cells)} LM cells of {n_cells}, or one not OK or measured nothing")
    require(len(counted) == 1, f"{len(counted)} counted steps, expected 1")
    require_entries("the counted accumulated step", counted[0], per_step)
    require(train_launches == {k: whole * per_step.get(k, 0) for k in train_launches},
            f"the phase launched {train_launches}, expected {whole} whole steps of {per_step}")
    by_kernel = {"flash_attention_fwd": 8 * D * pairs * L * g, "flash_attention_bwd_dkv": 8 * D * pairs * L * g,
                 "flash_attention_bwd_dq": 6 * D * pairs * L * g}
    require(out["kernel_flops"] == by_kernel and sum(out["kernel_flops"].values()) == kernel_flops,
            f"kernel FLOPs {out['kernel_flops']}, expected {by_kernel}")
    require(1 / SOLO_LIMIT <= out["solo_over_g_train_steps"] <= SOLO_LIMIT,
            f"solo step {out['solo_step_ms']:.1f} ms against {g} x phase_train's {trained['median_step_device_ms']:.1f}")

    # ---- (b) serving through InstanceRuntime.characterize, the whole card
    inst = partition(DEV, [Placement(sku.full_profile, 0)], partitioned=False, sku=sku)[0]
    rt = InstanceRuntime(inst, partitioned=False, sku=sku, measurements=measurements)
    serving = {}
    for kind, seq, kernel, median in (("prefill", PROMPT, "flash_attention_fwd", "prefill_device_ms_median"),
                                      ("decode", PROMPT + NEW, "decode_attention", "decode_step_device_ms_median")):
        job = JobSpec(f"{ARCH}#{kind}", ARCH, ShapeSuite(f"{kind}_{seq}", seq, BATCH, kind))
        reset_launch_counts()
        t1 = time.perf_counter()
        counted.clear()
        with counted_steps_recorded(counted):
            rec = rt.characterize(job)
        launches = launch_counts()
        torch.cuda.empty_cache()
        serving[kind] = {"batch": BATCH, "seq": seq, "step_ms": rec.step_s * 1e3, "phase_serve_ms": served[median],
                         "over_phase_serve": rec.step_s * 1e3 / served[median], "bound": rec.bound,
                         "compute_ms": rec.compute_s * 1e3, "memory_ms": rec.memory_s * 1e3,
                         "peak_bytes": rec.peak_bytes_per_device, "launches": launches,
                         "counted_step": counted[0][:2] if counted else None,
                         "measured": rt.measured_fields(job), "wall_s": time.perf_counter() - t1}
        require(len(counted) == 1, f"{kind}: {len(counted)} counted steps, expected 1")
        require_entries(f"the counted {kind} step", counted[0], {kernel: L})
        require(1 / SOLO_LIMIT <= serving[kind]["over_phase_serve"] <= SOLO_LIMIT,
                f"{kind} step {serving[kind]['step_ms']:.2f} ms against phase_serve's {served[median]:.2f}")
    emit("collocate_lm_serve", arch=cfg.name, **serving)

    # ---- (c) a workload whose state exceeds the card: skipped, nothing allocated
    skip_cfg, skip_suite, samples, skip_g = collocate.workload_suite(COLLOCATE_LM_SKIPPED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        skipped = collocate.characterize_workload(COLLOCATE_LM_SKIPPED, skip_cfg, skip_suite, samples, DEV, Path(tmp),
                                                  measurements, grad_accum=skip_g)
        written = sorted(f.name for f in Path(tmp).iterdir())
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    emit("collocate_lm_skip", skipped=skipped["skipped"], cells=len(skipped["cells"]), written=written,
         memory_allocated_before=held, memory_allocated_after=after)
    require(skipped["skipped"] is not None and skipped["skipped"]["state_bytes"] > skipped["skipped"]["budget_bytes"]
            and not skipped["cells"] and not written and skipped["failures"] == 0,
            f"{COLLOCATE_LM_SKIPPED} was not skipped: {skipped}")
    require(after == held, f"skipping {COLLOCATE_LM_SKIPPED} moved the card's allocation {held} -> {after}")
    emit("collocate_lm_wall", seconds=time.perf_counter() - t0)
    return {"train": out, "serve": serving}


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


# the examples/ twins (phase_examples), each through its main(argv) in this
# process at its own defaults on the card: quickstart's llama3-8b at full
# width and depth 2 (head_dim 128, G = 4; its one-step check at the training
# setup), train_lm's lm-100m, the sweep's seven granite-3-2b jobs and the
# failover's three (full width, depth 2)
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"


def load_example(name: str):
    """``examples/<name>.py`` as a module; its ``main`` is called by the phase."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_deltas(record: list):
    """A wrapper that appends the K1-K5 launch counts of each call to ``record``."""
    def wrap(fn):
        def counted(*args, **kwargs):
            before = launch_counts()
            out = fn(*args, **kwargs)
            after = launch_counts()
            record.append({k: after[k] - before[k] for k in after})
            return out
        return counted
    return wrap


def wall_of(record: list):
    """A wrapper that appends the host seconds of each call to ``record``."""
    def wrap(fn):
        def clocked(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record.append(time.perf_counter() - t0)
            return out
        return clocked
    return wrap


def step_medians(times: list, skip: int = 3) -> dict:
    """Medians of (host ms, device ms) step readings past the first ``skip``."""
    return {"median_step_ms": statistics.median(t[0] for t in times[skip:]),
            "median_step_device_ms": statistics.median(t[1] for t in times[skip:])}


def probed_calls(fn_wrapped, records: dict):
    """A wrapper that runs each call inside ``attention_probed(records)``."""
    def call(*args, **kwargs):
        with attention_probed(records):
            return fn_wrapped(*args, **kwargs)
    return call


def example_quickstart() -> dict:
    """llama3-8b at full width and depth 2 (head_dim 128, G 4: a shape the
    other phases do not give K1-K4): K1-K4 against their plain versions at
    the shapes the twin gives them (training (4, 64) causal, forward and
    backward; the caches of the generate loop); ``one_step`` at the training
    setup (batch 2, seq 4096) against the non-kernel path; then the twin's
    main: 30 steps, the checkpoint round trip (bit for bit), 8 tokens
    generated with every K1 and K4 call held to its plain version on its own
    inputs (``attention_probed``); K1 2L a step and L in the prefill, K2/K3 L
    a step, K4 L in each of the 7 decode steps."""
    qs = load_example("quickstart_torch")
    cfg = qs.quickstart_config()
    L, H, KVH, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    require(cfg.remat and D == 128 and cfg.q_groups == 4 and cfg.vocab == 128256
            and not cfg.tie_embeddings, f"llama3-8b's widths: {cfg}")
    gen = torch.Generator(device=DEV).manual_seed(25)
    B, S, prompt = qs.SUITE.global_batch, qs.SUITE.seq_len, 8
    smax = prompt + qs.NEW_TOKENS
    kernels = {
        "flash_attention_fwd": [flash_case(gen, B, S, S, H, KVH, D, True),            # the 30 steps' shape
                                flash_case(gen, 2, prompt, prompt, H, KVH, D, True)],  # the prefill's
        "flash_attention_bwd": [flash_bwd_case(gen, B, S, S, H, KVH, D, True, repeat=True)],
        "decode_attention": decode_case(gen, 2, smax, H, KVH, D, [prompt + 1, smax - 1, smax]),
        "tolerance": {"o": TOL_BF16, "lse": TOL_LSE},
    }
    one = one_step(cfg, build_model(cfg), make_plan(cfg, None))
    torch.cuda.empty_cache()
    per_step, times, ckpt_s, probed = [], [], [], {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, flash_launches_per_step(per_step, times), \
            rebound(qs, "round_trip", wall_of(ckpt_s)), \
            rebound(qs, "greedy_generate", lambda fn: probed_calls(fn, probed)):
        t0 = time.perf_counter()
        r = qs.main(["--ckpt-dir", f"{tmp}/ckpt"])
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"flash_attention_fwd": qs.STEPS * 2 * L + L, "flash_attention_bwd_dkv": qs.STEPS * L,
                "flash_attention_bwd_dq": qs.STEPS * L, "decode_attention": L * (qs.NEW_TOKENS - 1),
                "wkv6_scan": 0}
    tokens = r["tokens"]
    generate_calls = {
        name: {"calls": len(recs), "elements_beyond": sum(rec[0] for rec in recs),
               "worst_err_over_allowed": max((rec[1] for rec in recs), default=0.0),
               "max_abs_err": max((rec[2] for rec in recs), default=0.0)}
        for name, recs in probed.items()}
    out = {
        "arch": cfg.name, "layers": L, "head_dim": D, "q_groups": cfg.q_groups,
        "params": build_model(cfg).param_count(), "suite": dataclasses.astuple(qs.SUITE),
        "kernels": kernels,
        "one_step": {k: one[k] for k in ("batch", "seq", "loss_abs_err", "grad_rel_l2_attention_max",
                                         "grad_rel_l2_other_max", "launches")},
        "generate_attention_calls": generate_calls,
        "generate_tolerance": f"{TOL_ROW_RMS} * rms(row) + 1 ulp, against kernels/ref.py in f32",
        "losses": r["losses"], "grad_norms": r["grad_norms"], **step_medians(times),
        "ckpt_exact": r["ckpt_exact"], "ckpt_step": r["ckpt_step"], "ckpt_bytes": ckpt_bytes,
        "ckpt_round_trip_s": ckpt_s[0], "tokens": tokens.tolist(), "wall_s": wall, "peak_memory_gb": peak_gb,
        "launches": launches, "launches_expected": expected,
    }
    emit("example_quickstart", **out)
    require(launches == expected, f"quickstart launched {launches}, expected {expected}")
    require(generate_calls["flash_attention_fwd"]["calls"] == L
            and generate_calls["decode_attention"]["calls"] == L * (qs.NEW_TOKENS - 1),
            f"the generate loop's probed attention calls {generate_calls}")
    require(all(rec["elements_beyond"] == 0 for rec in generate_calls.values()),
            f"a K1 or K4 call of the generate loop is beyond its plain version's tolerance: {generate_calls}")
    require(all(c == (2 * L, L, L) for c in per_step) and len(per_step) == qs.STEPS,
            f"quickstart's per-step (K1, K2, K3) {per_step}")
    require(r["ckpt_exact"] and r["ckpt_step"] == qs.STEPS, "the checkpoint did not restore the saved state")
    require(np.isfinite(r["losses"]).all() and np.isfinite(r["grad_norms"]).all(), f"losses {r['losses']}")
    require(tuple(tokens.shape) == (2, qs.NEW_TOKENS) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.padded_vocab, f"generated {tokens}")
    del r, tokens
    return out


def example_train_lm() -> dict:
    """lm-100m through the launcher at the reference's defaults (200 steps,
    batch 8, seq 256): the loss falls; remat off, so K1-K3 L a step each."""
    tl = load_example("train_lm_torch")
    cfg = tl.LM100M
    L = cfg.n_layers
    require(not cfg.remat and cfg.resolved_head_dim == 64, f"lm-100m: {cfg}")
    per_step, times = [], []
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp, flash_launches_per_step(per_step, times):
        r = tl.main(["--ckpt-dir", f"{tmp}/ckpt"])
    launches = launch_counts()
    steps = r["steps"]
    expected = {"flash_attention_fwd": steps * L, "flash_attention_bwd_dkv": steps * L,
                "flash_attention_bwd_dq": steps * L, "decode_attention": 0, "wkv6_scan": 0}
    tokens = 8 * 256
    out = {"arch": cfg.name, "params": build_model(cfg).param_count(), "steps": steps,
           "batch": 8, "seq": 256, **{k: r[k] for k in ("first_loss", "final_loss", "head_mean_loss",
                                                         "tail_mean_loss", "mean_step_ms", "wall_s")},
           **step_medians(times), "tokens_per_s": tokens / (r["mean_step_ms"] * 1e-3),
           "pipeline": r["pipeline"], "launches": launches, "launches_expected": expected}
    emit("example_train_lm", **out)
    require(steps == 200 and r["final_loss"] < r["first_loss"] and r["tail_mean_loss"] < r["head_mean_loss"],
            f"lm-100m's loss did not fall: {out}")
    require(launches == expected, f"train_lm launched {launches}, expected {expected}")
    return out


def example_sweep() -> dict:
    """Seven granite-3-2b jobs (full width, depth 2) on the
    card's seven 1g.10gb instances, alone and then each in a thread on a
    stream of its own: the twin raises unless the traces are equal bit for
    bit; each solo peak within its instance's budget; the collocated peak
    within PEAK_LIMIT x the solo peaks' sum and the card; each pass's K1-K3
    launches the jobs' steps x (2L, L, L)."""
    sw = load_example("collocated_hparam_sweep_torch")
    passes = []
    torch.cuda.empty_cache()
    with rebound(sw, "run_pass", launch_deltas(passes)):
        r = sw.main([])
    cfg, solo, par = r["config"], r["solo"], r["par"]
    L, n_jobs = cfg.n_layers, len(r["instances"])
    steps = len(next(iter(solo["traces"].values())))
    expected = {"flash_attention_fwd": n_jobs * steps * 2 * L, "flash_attention_bwd_dkv": n_jobs * steps * L,
                "flash_attention_bwd_dq": n_jobs * steps * L, "decode_attention": 0, "wkv6_scan": 0}
    budgets = {a.job.name: inst.hbm_budget_bytes for a, inst in zip(r["schedule"].assignments, r["instances"])}
    card = torch.cuda.get_device_properties(DEV).total_memory
    out = {
        "arch": cfg.name, "layers": L, "params": build_model(cfg).param_count(), "jobs": n_jobs,
        "profiles": sorted({inst.label for inst in r["instances"]}), "steps": steps,
        "seq": r["suite"].seq_len, "batch": r["suite"].global_batch,
        "solo_wall_s": solo["wall_s"], "collocated_wall_s": par["wall_s"], "speedup": r["speedup"],
        "solo_job_wall_s": solo["job_wall_s"], "collocated_job_wall_s": par["job_wall_s"],
        "solo_peak_bytes": solo["peaks"], "budget_bytes": budgets,
        "solo_peak_share_of_budget_max": max(solo["peaks"][n] / budgets[n] for n in budgets),
        "collocated_peak_bytes": par["device_peak"], "solo_peaks_sum_bytes": sum(solo["peaks"].values()),
        "card_bytes": card, "traces_equal": all(par["traces"][n] == solo["traces"][n] for n in budgets),
        "final_losses": {n: t[-1] for n, t in par["traces"].items()}, "winner": r["winner"],
        "launches_solo": passes[0], "launches_collocated": passes[1], "launches_expected": expected,
    }
    emit("example_sweep", **out)
    require(out["traces_equal"], "a collocated trace differs from its solo trace")
    require(all(solo["peaks"][n] <= budgets[n] for n in budgets), "a solo peak exceeds its instance's budget")
    require(par["device_peak"] <= PEAK_LIMIT * out["solo_peaks_sum_bytes"] and par["device_peak"] <= card,
            f"collocated peak {par['device_peak']} beyond {PEAK_LIMIT} x {out['solo_peaks_sum_bytes']} or the card")
    require(passes[0] == expected and passes[1] == expected,
            f"sweep launches solo {passes[0]}, collocated {passes[1]}, expected {expected}")
    return out


def example_failover() -> dict:
    """Three granite-3-2b jobs (full width, depth 2), 4 steps,
    unit 0 fails, repack, 4 more: the killed job's 8 losses within TOL_RESUME
    of an uninterrupted run of the same job; the survivors keep their
    instances; every job ends with 8 losses; K1-K3 (2L, L, L) a step."""
    el = load_example("elastic_failover_torch")
    per_step, times = [], []
    reset_launch_counts()
    torch.cuda.empty_cache()
    with flash_launches_per_step(per_step, times):
        r = el.main([])
    launches = launch_counts()
    cfg, event, traces = r["config"], r["event"], r["traces"]
    L, total = cfg.n_layers, el.STEPS_BEFORE + el.STEPS_AFTER
    before = {a.job.name: a.placement for a in r["schedule"].assignments}
    after = {a.job.name: a.placement for a in event.new_schedule.assignments}
    uninterrupted = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in event.killed_jobs:
            inst = el.instance_of(DEV, after[name], el.SKU)
            uninterrupted[name] = el.train_steps(inst, cfg, r["suite"], CheckpointStore(f"{tmp}/{name}"), name,
                                                 total, seed=el.job_seed(name))
    rel = {n: max(abs(a - b) / abs(b) for a, b in zip(traces[n], uninterrupted[n])) for n in uninterrupted}
    expected = {"flash_attention_fwd": len(traces) * total * 2 * L, "flash_attention_bwd_dkv": len(traces) * total * L,
                "flash_attention_bwd_dq": len(traces) * total * L, "decode_attention": 0, "wkv6_scan": 0}
    out = {"arch": cfg.name, "layers": L, "seq": r["suite"].seq_len, "batch": r["suite"].global_batch,
           "killed": list(event.killed_jobs), "survivors": list(event.survivors),
           "moved": {n: [before[n].start, after[n].start] for n in event.killed_jobs},
           "traces": traces, "uninterrupted": uninterrupted, "resume_rel_err_max": rel, "rtol": TOL_RESUME,
           **step_medians(times, skip=1), "launches": launches, "launches_expected": expected}
    emit("example_failover", **out)
    require(event.killed_jobs and all(v <= TOL_RESUME for v in rel.values()),
            f"a resumed trace is not the uninterrupted one: {rel}")
    require(all(after[n] == before[n] for n in event.survivors), "a survivor was moved")
    require(all(len(t) == total and np.isfinite(t).all() for t in traces.values()) and set(traces) == set(before),
            f"traces {traces}")
    require(launches == expected, f"failover launched {launches}, expected {expected}")
    require(len(per_step) == len(traces) * total and all(c == (2 * L, L, L) for c in per_step),
            f"failover's per-step (K1, K2, K3) {per_step}, expected {(2 * L, L, L)} each")
    return out


def phase_examples() -> dict:
    """The four examples/ twins on the card, each through its ``main(argv)``."""
    out = {"quickstart": example_quickstart()}
    torch.cuda.empty_cache()
    out["train_lm"] = example_train_lm()
    torch.cuda.empty_cache()
    out["sweep"] = example_sweep()
    torch.cuda.empty_cache()
    out["failover"] = example_failover()
    torch.cuda.empty_cache()
    return out


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
    phase_g7(get_config(LLAVA_ARCH))
    shards = phase_shards()
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
    meshed = phase_mesh(cfg)
    torch.cuda.empty_cache()
    families = phase_mesh_families()
    torch.cuda.empty_cache()
    recurrent = phase_mesh_recurrent()
    torch.cuda.empty_cache()
    phase_dryrun(cfg)
    torch.cuda.empty_cache()
    slm_train = stablelm_train_config()
    slm_step = one_step(slm_train, build_model(slm_train), make_plan(slm_train, None), STABLELM_TOL)
    torch.cuda.empty_cache()
    zamba_train = zamba_train_config()
    zamba_step = one_step(zamba_train, build_model(zamba_train), make_plan(zamba_train, None), ZAMBA_TOL)
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
    torch.cuda.empty_cache()
    lm = phase_collocate_lm(cfg, trained, served[cfg.name])
    torch.cuda.empty_cache()
    examples = phase_examples()
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
    # zamba2-7b's serving path, K1-K3 (launches_train for K1) on its one
    # training step at depth 4. launches_serve: K1 and K4 on the serving paths
    # of deepseek-moe-16b, zamba2-7b and whisper-base; launches_one_step: K1,
    # K2 and K3 in the one-step checks of olmoe-1b-7b and whisper-base. In
    # phase mesh: K1-K3 in one sharded train step (launches_mesh_step,
    # baseline), K1 in its sharded prefill and K4 in its sharded decode step.
    # In phase mesh_families, by arch: K1-K3 in one sharded train step
    # (launches_mesh_train, baseline), K1 in the sharded prefill
    # (launches_mesh_prefill) and K4 in the sharded decode step
    # (launches_mesh_decode), baseline. In phase shards: K1-K4 on the 16
    # emulated model ranks' parts, checked and timed (launches_shards), and
    # K1-K3 on their row_split shares where model does not divide the query
    # heads (rows_shares: whisper-base's self and cross attention, llava's G 7).
    bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    mesh_step = meshed["train"]["baseline"]["launches_per_step"][0]
    mesh_train = [{a: r["baseline"]["launches_per_step"][0][i] for a, r in families["train"].items()} for i in range(3)]
    mesh_prefill = {a: r["baseline"]["prefill_k1"] for a, r in families["serve"].items()}
    mesh_decode = {a: r["baseline"]["decode_k4"] for a, r in families["serve"].items()}
    rec_train = [{a: r["baseline"]["launches_per_step"][0][i] for a, r in recurrent["train"].items()} for i in range(3)]
    rec_prefill = {a: r["baseline"]["prefill_k1"] for a, r in recurrent["serve"].items() if r["baseline"]["prefill_k1"]}
    rec_decode = {a: r["baseline"]["decode_k4"] for a, r in recurrent["serve"].items() if r["baseline"]["decode_k4"]}
    slm_served = served[slm_cfg.name]["launches"]
    slm_k1, slm_k2, slm_k3 = slm_step["launches"]

    one_k123 = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                        examples["quickstart"]["one_step"]["launches"]))

    def by_example(name):
        """A kernel's launches in each run of phase_examples."""
        ex = examples
        return {"quickstart_one_step": one_k123.get(name, 0), "quickstart": ex["quickstart"]["launches"][name],
                "train_lm": ex["train_lm"]["launches"][name], "sweep_solo": ex["sweep"]["launches_solo"][name],
                "sweep_collocated": ex["sweep"]["launches_collocated"][name],
                "failover": ex["failover"]["launches"][name]}
    def row_shares(name):
        """phase shards' row_split cases for K1-K3: the launches of the 16
        ranks' shares, the largest error against the whole call, and ranks
        0's and 1's shares timed beside their bounds."""
        short, errs = {"flash_attention_fwd": ("fwd", ("o", "lse")), "flash_attention_bwd_dkv": ("dkv", ("dk", "dv")),
                       "flash_attention_bwd_dq": ("dq", ("dq",))}[name]
        return {case: {"launches": r["launches"][short], "max_abs_err": max(r["vs_whole"][e] for e in errs),
                       **{rank: t[name] for rank, t in shards["rows_timed"][case].items()},
                       "busiest_over_mean_k123": shards["rows_balance"][case]["busiest_over_mean"]}
                for case, r in shards["rows"].items()}

    emit("wall", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [
        dict(row(flash, "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
                 "src/repro/kernels/flash_attention.py:159", served[cfg.name]["launches"]["flash_attention_fwd"]),
             launches_train=trained["launches"]["flash_attention_fwd"],
             max_abs_err_train=dkv["forward_max_abs_err"],
             launches_calibrate=calib["launches"]["flash_attention"],
             launches_calibrate_kernel=calib_k["flash_attention"]["launches"],
             d160=dict(at160("flash_attention_fwd", slm_served["flash_attention_fwd"]), launches_train=slm_k1),
             d112=dict(at_dim(d112, "flash_attention_fwd", served[ZAMBA_ARCH]["launches"]["flash_attention_fwd"]),
                       launches_train=zamba_step["launches"][0]),
             launches_serve=served_by["flash_attention_fwd"], launches_one_step=stepped_by[0],
             launches_mesh_step=mesh_step[0], launches_mesh_prefill=meshed["serve"]["baseline"]["prefill_k1"],
             launches_mesh_train=mesh_train[0], launches_mesh_prefill_families=mesh_prefill,
             launches_mesh_train_recurrent=rec_train[0], launches_mesh_prefill_recurrent=rec_prefill,
             launches_collocate_lm={"train": lm["train"]["launches"]["flash_attention_fwd"],
                                    "prefill": lm["serve"]["prefill"]["launches"]["flash_attention_fwd"],
                                    "decode_cache_fill": lm["serve"]["decode"]["launches"]["flash_attention_fwd"]},
             launches_examples=by_example("flash_attention_fwd"),
             launches_shards=shards["launches"]["flash_attention_fwd"], rows_shares=row_shares("flash_attention_fwd")),
        dict(row(decode, "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:126", served[cfg.name]["launches"]["decode_attention"]),
             launches_calibrate_kernel=calib_k["decode_attention"]["launches"],
             d160=at160("decode_attention", slm_served["decode_attention"]),
             d112=at_dim(d112, "decode_attention", served[ZAMBA_ARCH]["launches"]["decode_attention"]),
             launches_serve=served_by["decode_attention"], launches_mesh_decode=meshed["serve"]["baseline"]["decode_k4"],
             launches_mesh_decode_families=mesh_decode, launches_mesh_decode_recurrent=rec_decode,
             launches_collocate_lm=lm["serve"]["decode"]["launches"]["decode_attention"],
             launches_examples=by_example("decode_attention"),
             launches_shards=shards["launches"]["decode_attention"]),
        dict(row(dkv, bwd_src, dkv["replaces"], trained["launches"]["flash_attention_bwd_dkv"]),
             d160=at160("flash_attention_bwd_dkv", slm_k2),
             d112=at_dim(d112, "flash_attention_bwd_dkv", zamba_step["launches"][1]), launches_one_step=stepped_by[1],
             launches_mesh_step=mesh_step[1], launches_mesh_train=mesh_train[1],
             launches_mesh_train_recurrent=rec_train[1],
             launches_collocate_lm=lm["train"]["launches"]["flash_attention_bwd_dkv"],
             launches_examples=by_example("flash_attention_bwd_dkv"),
             launches_shards=shards["launches"]["flash_attention_bwd_dkv"], rows_shares=row_shares("flash_attention_bwd_dkv")),
        dict(row(dq, bwd_src, dq["replaces"], trained["launches"]["flash_attention_bwd_dq"]),
             d160=at160("flash_attention_bwd_dq", slm_k3),
             d112=at_dim(d112, "flash_attention_bwd_dq", zamba_step["launches"][2]), launches_one_step=stepped_by[2],
             launches_mesh_step=mesh_step[2], launches_mesh_train=mesh_train[2],
             launches_mesh_train_recurrent=rec_train[2],
             launches_collocate_lm=lm["train"]["launches"]["flash_attention_bwd_dq"],
             launches_examples=by_example("flash_attention_bwd_dq"),
             launches_shards=shards["launches"]["flash_attention_bwd_dq"], rows_shares=row_shares("flash_attention_bwd_dq")),
        dict(row(wkv, "src/repro_torch/kernels/csrc/wkv6_scan.cu", wkv["replaces"],
                 served_rwkv["launches"]["wkv6_scan"]),
             launches_calibrate_kernel=calib_k["wkv6"]["launches"],
             launches_mesh_prefill=recurrent["serve"][RWKV_ARCH]["baseline"]["prefill_k5"],
             pytorch_yardstick_ms=wkv["chunked_ms"], pytorch_yardstick="models.rwkv6.wkv_chunked"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
