"""Shared body of the per-family multi-rank files (``test_torch_mesh_vlm.py``,
``test_torch_mesh_moe.py``, ``test_torch_mesh_encdec.py``,
``test_torch_mesh_rwkv.py``, ``test_torch_mesh_hybrid.py``,
``test_torch_mesh_resnet.py``): a family's
sharded steps on a 2 x 4 (data, model) gloo mesh against the port's own
single-device path, one process a rank.

``run_family`` runs this file as a script in a subprocess, which spawns the
eight ranks (``torch.multiprocessing``) over a ``FileStore`` in a temporary
directory, so no TCP port is taken; rank 0 writes what it found as JSON. Each
family file is its own test file, so that ``--dist loadfile`` puts them on
different workers. The limits are the reference's (tests/test_variants.py:
loss 3e-2, decode logits 6e-2) and ``test_torch_mesh_ranks.py``'s for the
gradients:

  * ``jit_train_step`` (baseline, sp), two steps against ``build_train_step``
    on the same batch: the losses, the gradient norms and AdamW's first moment
    after the first step;
  * ``jit_prefill_step`` and ``jit_decode_step`` (baseline, serve) against the
    single-device prefill and decode: the logits, the cache the prefill wrote,
    the decode's new K/V slot written in place and every other slot
    unchanged, its recurrent states written in place whole (``TOL_STATE``).

The MoE family's sharded runs route by the single-device run's choices
(``routes_recorded``), as ``chip_smoke.py`` replays them: the two paths round
attention differently, and on the reduced configs' near-ties that flips a
token's top-k experts, which moves everything after it by O(1).
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

MESH = (2, 4)
TOL_LOSS, TOL_LOGITS, TOL_LOGITS_HARD = 3e-2, 6e-2, 0.25
#: the first step's gradient norm (relative) and the relative L2 error of
#: AdamW's first moment after it, and the second step's norm. Read: at most
#: 1.4e-3 (olmoe under sp; 2.6e-4 for the dense family in
#: test_torch_mesh_ranks.py, whose limit is 1e-3), 2.3e-2 and 2.2e-3
STEP1_GRAD_NORM_RTOL, STEP1_MOMENT_RTOL, STEP2_GRAD_NORM_RTOL = 3e-3, 3e-2, 2e-2
#: a recurrent state's error relative to its largest element (``_state_err``).
#: Read, prefill and decode: at most 0.014 (zamba2's conv tail); a state the
#: decode step does not write (the prefill's left in place) reads 0.080 (zamba2's
#: ssm state) to 1.67 (rwkv6's token-shift tails)
TOL_STATE = 3e-2
TIMEOUT_S = 300
B, S_TRAIN, S_PROMPT = 8, 32, 31
#: the cache leaves an attention writes slot by slot at decode; the recurrent
#: states (the wkv and ssm states, the token-shift and conv tails) are
#: replaced whole by each decode step; any other leaf (whisper's cross K/V)
#: is written by the prefill alone
ATTN_CACHES = ("k", "v", "attn_k", "attn_v")
RECURRENT_CACHES = ("wkv", "ssm", "tm_x", "cm_x", "conv")


def prompt_len(cfg) -> int:
    """The prompt: 31 tokens, ragged against the attention kernels' tiles; a
    recurrent family's is three of its chunks (24 at the reduced chunk of 8),
    because the plain scans ``wkv_chunked`` and ``ssd_chunked`` assert that
    the chunk divides the sequence, as the reference's own do."""
    return S_PROMPT if cfg.ssm is None else 3 * cfg.ssm.chunk


def run_family(train_arch: str, serve_arch: Optional[str], tmp: Path, extra: Tuple[str, ...] = ()) -> dict:
    """The train and serve cases of one family on the 2 x 4 mesh, and the
    cases named in ``extra`` (``case_<name>``); rank 0's result.
    ``serve_arch`` None: a family that does not serve (resnet)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, __file__, train_arch, serve_arch or "-", str(tmp), ",".join(extra)],
                         capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads((tmp / "result.json").read_text())


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _batch(cfg, suite):
    from repro_torch.convert import from_jax_params  # numpy leaves, bfloat16 ones included
    from repro_torch.data import synthetic

    return from_jax_params(synthetic.batch_for(cfg, suite, seed=0), "cpu")


@contextlib.contextmanager
def routes_recorded(record: list, replay=None):
    """Inside the block every MoE layer call appends its top-k expert ids
    (whole) to ``record``; with ``replay`` (another run's record, one entry a
    call in the same order) each call routes by the replayed ids, its gates
    its own probabilities at those experts renormalized as ``top_k_gates``
    does. A DTensor call gets the replayed ids in its own placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.sharding import dist

    saved = moe.top_k_gates
    replayed = iter(replay) if replay is not None else None

    def recording(probs, k, renormalize=True):
        vals, idx = saved(probs, k, renormalize)
        record.append(dist.full(idx))
        if replayed is None:
            return vals, idx
        forced = next(replayed)
        if dist.is_dtensor(idx):
            forced = distribute_tensor(forced, idx.device_mesh, idx.placements)
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
def local_shapes_recorded(found: dict):
    """Inside the block, the local shapes that reach the kernels' plain
    versions and the loss, as sets in ``found``: ``flash`` (KV heads, query
    heads a KV head) of each flash call's folded q, ``decode`` (query heads,
    KV heads, cache rows, whether the log-sum-exp was asked for) of each
    decode call, ``vocab`` the vocab width of each loss shard
    (``losses.shard_terms``), ``table`` the rows of each embedding table
    looked up in, ``rows`` (query rows, ``q_offset``) of each flash call and
    ``proj`` the local width of each of rwkv6's time-mix products
    (``rwkv6._head_proj``). They show which path the sharded boundary took."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import losses, rwkv6
    from repro_torch.sharding import dist

    saved = fa.flash_attention_fwd, da.decode_attention, losses.shard_terms, F.embedding
    saved_proj = rwkv6._head_proj
    for key in ("flash", "decode", "vocab", "table", "rows", "proj"):
        found.setdefault(key, set())

    def flash(q, *a, **kw):
        found["flash"].add(tuple(q.shape[i] for i in (1, 3)))
        found["rows"].add((q.shape[2], kw.get("q_offset", 0)))
        return saved[0](q, *a, **kw)

    def proj(plan, w, x):
        out = saved_proj(plan, w, x)
        found["proj"].add(dist.local(out).shape[-1])
        return out

    def decode(q, k_cache, *a, **kw):
        found["decode"].add((q.shape[1], k_cache.shape[2], k_cache.shape[1], bool(kw.get("return_lse"))))
        return saved[1](q, k_cache, *a, **kw)

    def terms(lf, *a, **kw):
        found["vocab"].add(lf.shape[-1])
        return saved[2](lf, *a, **kw)

    def embedding(ids, weight, *a, **kw):
        found["table"].add(weight.shape[0])
        return saved[3](ids, weight, *a, **kw)

    fa.flash_attention_fwd, da.decode_attention, losses.shard_terms, F.embedding = flash, decode, terms, embedding
    rwkv6._head_proj = proj
    try:
        yield
    finally:
        fa.flash_attention_fwd, da.decode_attention, losses.shard_terms, F.embedding = saved
        rwkv6._head_proj = saved_proj


def _sorted_shapes(found: dict) -> dict:
    return {k: sorted(v) for k, v in found.items()}


def _two_steps(step, state, batch):
    from repro_torch.models.module import tree_leaves
    from repro_torch.sharding import dist

    res, moments = {"loss": [], "grad_norm": []}, []
    for _ in range(2):
        state, m = step(state, batch)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        moments.append([dist.full(mu).detach().float().clone() for mu in tree_leaves(state["opt"].m)])
    return res, moments


def _rel_l2(got, want) -> float:
    errs = []
    for g, w in zip(got, want):
        ref, diff = float(w.norm()), float((g - w).norm())
        errs.append(diff / ref if ref > 0 else diff)
    return max(errs)


#: reduced configs whose query heads ``model`` (4) does not divide
#: (``dist.row_split``): whisper-base with 6 heads (2 groups of 3 heads, each
#: over 2 slices of the rows) and 6 frames, which ``model`` does not divide
#: either, so the decode's cross caches stay whole on every rank;
#: llava-next-34b with 14 over 2 KV heads (2 groups of 7 heads, G 7, one KV
#: head a group)
ROW_SPLIT = {"whisper-base": dict(n_heads=6, n_kv_heads=6, n_frames=6),
             "llava-next-34b": dict(n_heads=14, n_kv_heads=2)}


def case_train(mesh, arch: str, overrides: Optional[dict] = None, variants=("baseline", "sp")) -> dict:
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_api import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding import dist
    from repro_torch.sharding.plan import make_plan

    opt = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    cfg = get_config(arch).reduced(**(overrides or {}))
    model = build_model(cfg)
    suite = ShapeSuite("t", S_TRAIN, B, "train")
    batch = _batch(cfg, suite)
    init = lambda: ts.init_train_state(model, torch.Generator().manual_seed(0), opt, "cpu")  # noqa: E731
    routes = []
    with routes_recorded(routes):
        res, want = _two_steps(ts.build_train_step(model, make_plan(cfg, None), opt), init(), batch)
    found = {"single": res}
    for variant in variants:
        step, st_sh, b_sh, _ = ts.jit_train_step(model, mesh, suite, opt, variant=variant)
        shapes = {}
        with routes_recorded([], routes), local_shapes_recorded(shapes):
            res, got = _two_steps(step, dist.distribute(init(), st_sh), dist.distribute(batch, b_sh))
        found[variant] = dict(res, moment_err=[_rel_l2(g, w) for g, w in zip(got, want)],
                              local_shapes=_sorted_shapes(shapes))
    return found


def _state_err(got, want) -> float:
    """A recurrent state's largest error, relative to its largest element
    (at least 1): an f32 state grows with the prompt (rwkv6's wkv state
    reaches 13.8 at 24 tokens), and bf16's partial sums over the model axis
    move it in proportion."""
    want = want.float()
    return float((got.full_tensor().float() - want).abs().max()) / max(1.0, float(want.abs().max()))


def case_serve(mesh, arch: str, overrides: Optional[dict] = None, variants=("baseline", "serve"),
               batch: int = B) -> dict:
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_api import build_model
    from repro_torch.runtime import serve_step as serve
    from repro_torch.sharding import dist
    from repro_torch.sharding.plan import make_plan

    cfg = get_config(arch).reduced(**(overrides or {}))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    plan0 = make_plan(cfg, None)
    S = prompt_len(cfg)
    prompt = _batch(cfg, ShapeSuite("p", S, batch, "prefill"))
    prompt.pop("labels", None)
    prefill_routes, decode_routes = [], []
    with torch.no_grad(), routes_recorded(prefill_routes):
        last, cache = model.prefill(params, prompt, plan0)
    cache = serve.pad_cache(cache, 1)
    tok = torch.argmax(last, -1).to(torch.int32)
    written = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad(), routes_recorded(decode_routes):
        want, _ = model.decode(params, {"token": tok}, written, S, plan0)
    attn = [n for n in cache if n in ATTN_CACHES]
    recurrent = [n for n in cache if n in RECURRENT_CACHES]
    out = {}
    for variant in variants:
        step, p_sh, b_sh, _ = serve.jit_prefill_step(model, mesh, ShapeSuite("p", S, batch, "prefill"),
                                                     variant=variant)
        prefill_shapes, decode_shapes = {}, {}
        with routes_recorded([], prefill_routes), local_shapes_recorded(prefill_shapes):
            got, c = step(dist.distribute(params, p_sh), dist.distribute(prompt, b_sh))
        diff = (got.full_tensor().float() - last.float()).abs()
        out["prefill_" + variant] = {
            "logits_err": float(diff.max()), "beyond": float((diff > TOL_LOGITS).float().mean()),
            "cache_err": max([float((c[n].full_tensor().float() - cache[n][:, :, :c[n].shape[2]].float()).abs().max())
                              for n in c if n not in recurrent], default=0.0),
            "state_err": max([_state_err(c[n], cache[n]) for n in recurrent], default=0.0),
            "local_shapes": _sorted_shapes(prefill_shapes)}
        step, p_sh, tok_sh, c_sh, _ = serve.jit_decode_step(model, mesh, ShapeSuite("d", S + 1, batch, "decode"),
                                                            variant=variant)
        c = dist.distribute({k: v.clone() for k, v in cache.items()}, c_sh)
        with routes_recorded([], decode_routes), local_shapes_recorded(decode_shapes):
            logits, _ = step(dist.distribute(params, p_sh), dist.distribute({"token": tok}, tok_sh), c)
        diff = (logits.full_tensor().float() - want.float()).abs()
        out["decode_" + variant] = {
            "logits_err": float(diff.max()), "beyond": float((diff > TOL_LOGITS).float().mean()),
            # attention caches slot by slot: the new slot, every other one unchanged
            "slot_err": max([float((c[n].full_tensor()[:, :, S].float() - written[n][:, :, S].float()).abs().max())
                             for n in attn], default=0.0),
            # recurrent states whole (written in place too), against the single device's decode
            "state_err": max([_state_err(c[n], written[n]) for n in recurrent], default=0.0),
            "others_equal": all(bool(torch.equal(c[n].full_tensor()[:, :, :S], cache[n][:, :, :S])) for n in attn)
            and all(bool(torch.equal(c[n].full_tensor(), cache[n])) for n in c
                    if n not in attn and n not in recurrent),
            "local_shapes": _sorted_shapes(decode_shapes),
        }
    return out


def case_row_split(mesh, arch: str) -> dict:
    """``arch`` reduced with the heads of ``ROW_SPLIT``, which ``model`` does
    not divide: the baseline train step against the single device's, and
    the baseline prefill and decode against the single device's."""
    return {"train": case_train(mesh, arch, ROW_SPLIT[arch], ("baseline",)),
            "serve": case_serve(mesh, arch, ROW_SPLIT[arch], ("baseline",))}


def case_batch1(mesh, arch: str) -> dict:
    """The baseline prefill and decode at batch 1, which the data axis
    cannot split (as in the long_500k cells), against the single device's:
    there the stream's d lies over the data axis, and rwkv6's decode runs
    its channel mix's receptance product on each rank's columns as well."""
    return case_serve(mesh, arch, variants=("baseline",), batch=1)


def case_decode_idle(mesh, _arch=None) -> dict:
    """``ops.decode_attention`` on DTensors at batch 1 against the whole
    call: a cache replicated on every mesh dim (zamba2's shared block's
    cache at long_500k), query heads over ``model`` (2 of 8 a rank), and the
    data axis, which holds no batch to split, splitting each rank's cache
    rows; at kv_len that fills the cache, ends in the first data rank's rows
    (the second's empty) and is one row."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    H, D, smax = 8, 16, 24
    q = torch.randn(1, 1, H, D, generator=gen).to(torch.bfloat16)
    kc, vc = (torch.randn(1, smax, H, D, generator=gen).to(torch.bfloat16) for _ in range(2))
    whole = [Replicate(), Replicate()]
    errs, shapes = [], {}
    for n in (smax, 7, 1):
        kv_len = torch.tensor([n], dtype=torch.int32)
        want = ops.decode_attention(q, kc, vc, kv_len=kv_len)
        with local_shapes_recorded(shapes):
            got = ops.decode_attention(*(distribute_tensor(x, mesh, whole) for x in (q, kc, vc)), kv_len=kv_len)
        errs.append(float((got.full_tensor().float() - want.float()).abs().max()))
    return {"errs": errs, "local_shapes": _sorted_shapes(shapes)}


#: the largest error of ``case_row_share_boundary``'s gradients relative to
#: their largest element: two bf16 roundings where the whole call has one.
#: Read: dq 0.0; dk, dv at most 6.0e-3 (llava's grouping)
TOL_BOUNDARY_GRAD = 1e-2
#: (query heads, KV heads) of ``case_row_share_boundary``: llava-next-34b's
#: grouping (G 7, a KV head's columns over the two ranks of a group) and
#: whisper-base's (G 1, three heads a group)
BOUNDARY_HEADS = ((14, 2), (6, 6))


def case_row_share_boundary(mesh, _arch=None) -> dict:
    """The row shares' boundary on DTensors against the whole tensors, at a
    sequence of 32 rows, which ``model`` (4) divides: q, k and v as the
    column-parallel products leave them ((B, S, heads·D), the batch over
    ``data``, the columns over ``model``) through ``attention.heads`` (RoPE
    on the shares) and ``attention.attend``, against RoPE and the flash
    kernel's plain version on the whole tensors: the output (B, S, H·D), the
    gradients of q, k and v under a weighted sum, and ``write_cache`` into
    caches whose rows lie over ``model`` (the all-to-all of each rank's
    column block to the cache rows) and caches that hold them whole there
    (the column blocks gathered), bit for bit against the whole RoPE'd K and
    V, with the collectives each write ran (``counts.OpLog``'s kinds).
    Gradients relative to their largest element (``TOL_BOUNDARY_GRAD``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor, zeros

    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import module as nn
    from repro_torch.sharding import dist
    from repro_torch.sharding.plan import make_plan
    from repro_torch.telemetry import counts

    gen = torch.Generator().manual_seed(0)
    Bb, S, D, theta = 2, 32, 16, 10_000.0
    cols, plan = [Shard(0), Shard(2)], make_plan(None, None)
    found = {}
    for H, KVH in BOUNDARY_HEADS:
        q, w = (torch.randn(Bb, S, H * D, generator=gen).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(Bb, S, KVH * D, generator=gen).to(torch.bfloat16) for _ in range(2))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        positions = torch.arange(S)
        qh, kh = (nn.apply_rope(x.unflatten(-1, (n, D)), positions, theta) for x, n in zip(leaves[:2], (H, KVH)))
        want = ops.flash_attention(qh, kh, leaves[2].unflatten(-1, (KVH, D)), causal=True).flatten(2)
        want_grads = torch.autograd.grad((want.float() * w.float()).sum(), leaves)
        placed = [distribute_tensor(x, mesh, cols).requires_grad_() for x in (q, k, v)]
        h = attention.heads(plan, *placed, H, KVH, D, causal=True, theta=theta)
        got = attention.attend(h)
        with dist.implicit_replication():
            grads = torch.autograd.grad(dist.full((got.float() * w.float()).sum()), placed)
        # the gradients' largest error relative to their largest element: dk and dv are sums of
        # bf16 partials (the zig-zag's calls, the ranks of a KV head), the whole call's one rounding
        errs = {"out": float((got.full_tensor() - want).detach().float().abs().max()),
                "grads": [float((g.full_tensor().float() - x.float()).abs().max() / x.float().abs().max())
                          for g, x in zip(grads, want_grads)]}
        with torch.no_grad():
            h = attention.heads(plan, *placed, H, KVH, D, causal=True, theta=theta)
            for name, pl in (("rows", [Shard(1), Shard(2)]), ("whole", [Shard(1), Replicate()])):
                kc, vc = (zeros(1, Bb, S, KVH, D, dtype=torch.bfloat16, device_mesh=mesh, placements=pl)
                          for _ in range(2))
                with counts.OpLog() as log:
                    attention.write_cache(h, kc, vc, 0)
                errs[name] = [bool(torch.equal(kc.full_tensor()[0], kh.detach())),
                              bool(torch.equal(vc.full_tensor()[0], v.unflatten(-1, (KVH, D))))]
                errs[f"{name}_route"] = sorted({c.kind for c in log.collectives})
        errs["share"] = type(h).__name__
        found[f"{H}/{KVH}"] = errs
    return found


def case_wkv6(mesh, _arch=None) -> dict:
    """``ops.wkv6`` on DTensors against the whole call, on the CPU (K5's
    plain version on each rank's local shards): the inputs in the sp layout
    (batch over the data axes, sequence over ``model``), which the boundary
    brings to each rank's batch rows and heads; the outputs, their
    placements, and the gradients of every input."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.sharding import dist

    gen = torch.Generator().manual_seed(0)
    Bw, T, H, K = 4, 12, 8, 8
    r, k, v = (torch.randn(Bw, T, H, K, generator=gen) for _ in range(3))
    logw = -torch.exp(torch.randn(Bw, T, H, K, generator=gen))
    u, s0 = torch.randn(H, K, generator=gen), torch.randn(Bw, H, K, K, generator=gen)
    w_out, w_st = torch.randn(Bw, T, H, K, generator=gen), torch.randn(Bw, H, K, K, generator=gen)
    inputs = [r, k, v, logw, u, s0]

    def loss(out, st):
        return (out * w_out).sum() + (st * w_st).sum()

    leaves = [x.clone().requires_grad_() for x in inputs]
    out, st = ops.wkv6(*leaves)
    want = torch.autograd.grad(loss(out, st), leaves)
    seq = [Shard(0), Shard(1)]
    placed = [distribute_tensor(x, mesh, seq) for x in (r, k, v, logw)]
    placed += [distribute_tensor(u, mesh, [Replicate(), Replicate()]), distribute_tensor(s0, mesh, [Shard(0), Shard(1)])]
    placed = [x.requires_grad_() for x in placed]
    got_out, got_st = ops.wkv6(*placed)
    with dist.implicit_replication():  # the loss's weights, whole on every rank
        got = torch.autograd.grad(dist.full(loss(got_out, got_st)), placed)
    return {
        "out_err": float((got_out.full_tensor() - out).abs().max()),
        "state_err": float((got_st.full_tensor() - st).abs().max()),
        "grad_err": [float((g.full_tensor() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)],
        # the tensor dim each mesh dim shards (None: replicated)
        "out_placements": [pl.dim if pl.is_shard() else None for pl in got_out.placements],
        "state_placements": [pl.dim if pl.is_shard() else None for pl in got_st.placements],
    }


def _rank_main(rank: int, train_arch: str, serve_arch: str, tmp: str, extra: str = "") -> None:
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_shape

    torch.set_num_threads(1)
    world = int(np.prod(MESH))
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                             world_size=world)
    try:
        mesh = make_mesh_shape(MESH, ("data", "model"), device="cpu")
        result = {"train": case_train(mesh, train_arch)}
        if serve_arch != "-":
            result["serve"] = case_serve(mesh, serve_arch)
        for name in filter(None, extra.split(",")):
            result[name] = globals()["case_" + name](mesh, serve_arch)
        if rank == 0:
            Path(tmp, "result.json").write_text(json.dumps(result))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the checks each family file makes
# ---------------------------------------------------------------------------


def check_train(found: dict, variant: str, moment_rtol: float = STEP1_MOMENT_RTOL) -> None:
    got, want = found[variant], found["single"]
    assert all(np.isfinite(got["loss"])) and len(got["loss"]) == 2
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) < TOL_LOSS, (variant, got, want)
    assert abs(got["grad_norm"][0] - want["grad_norm"][0]) <= STEP1_GRAD_NORM_RTOL * want["grad_norm"][0], \
        (variant, got, want)
    assert got["moment_err"][0] < moment_rtol, (variant, got)
    assert abs(got["grad_norm"][1] - want["grad_norm"][1]) <= STEP2_GRAD_NORM_RTOL * want["grad_norm"][1], \
        (variant, got, want)


def _logits_within(r: dict, outliers: float) -> None:
    """Every logit within TOL_LOGITS; or, with ``outliers`` > 0, all but that
    share of them, and none beyond TOL_LOGITS_HARD."""
    if outliers:
        assert r["beyond"] <= outliers and r["logits_err"] < TOL_LOGITS_HARD, r
    else:
        assert r["logits_err"] < TOL_LOGITS, r


def check_prefill(found: dict, variant: str, outliers: float = 0.0) -> None:
    r = found["prefill_" + variant]
    _logits_within(r, outliers)
    assert r["cache_err"] < TOL_LOGITS and r["state_err"] < TOL_STATE, r


#: the local shapes of the reduced configs (4 query heads, 2 KV heads, vocab
#: 256) on the 2 x 4 mesh, where ``model`` divides the query heads but not
#: the KV heads: a rank's flash call takes one query head and the one KV head
#: it reads (KV heads 1, local group 1), the loss and the lookup a quarter of
#: the vocab, and a decode call all 4 query heads against the rank's rows of a
#: sequence-sharded cache (8 of 32), with the log-sum-exp for the merge
ONE_HEAD, VOCAB_SHARD = [1, 1], 64
SEQ_SHARD_DECODE = [4, 2, 8, True]


def check_local_shapes(r: dict, **want) -> None:
    """Each of ``want`` (a key of ``local_shapes_recorded``) is the sorted
    list of local shapes that the run recorded: the sharded path that ran."""
    got = r["local_shapes"]
    for key, shapes in want.items():
        assert got[key] == shapes, (key, got)


def check_decode(found: dict, variant: str, outliers: float = 0.0) -> None:
    r = found["decode_" + variant]
    _logits_within(r, outliers)
    assert r["slot_err"] < TOL_LOGITS and r["state_err"] < TOL_STATE and r["others_equal"], r


if __name__ == "__main__":
    import torch.multiprocessing as mp

    train_arch, serve_arch, tmp, extra = sys.argv[1:5]
    mp.spawn(_rank_main, args=(train_arch, serve_arch, tmp, extra), nprocs=int(np.prod(MESH)), join=True)
