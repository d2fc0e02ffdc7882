"""PyTorch port vs the JAX reference: the flash-attention backward.

``kernels/ref.py::flash_attention_bwd_reference`` is the plain version of the
two backward CUDA kernels (dk/dv and dq); ``chip_smoke.py`` holds the kernels
against it on the card. Here it is held against the JAX package's Pallas
backward in interpret mode, fed the same q, k, v, o, lse and do, and the
port's differentiable ``ops.flash_attention`` is held against ``jax.grad`` of
the reference's. Tolerances are the reference's own (tests/test_kernels.py):
flash grads 5e-4 in f32, 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BWD_CASES = [
    # (B, S, H, KVH, D, causal, dtype): the table of test_flash_bwd_matches_oracle, plus bf16
    (2, 64, 8, 2, 32, True, "float32"),
    (1, 64, 4, 4, 16, True, "float32"),
    (1, 64, 4, 2, 32, False, "float32"),
    (2, 64, 8, 4, 64, True, "bfloat16"),
    (1, 64, 8, 2, 160, True, "float32"),   # head_dim 160 (stablelm-12b), G=4
    (1, 64, 4, 1, 160, False, "bfloat16"),
]


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=5e-4, rtol=5e-4)


def _pair(rng, shape, dtype: str = "float32"):
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same type, bit for bit."""
    dtype = getattr(torch, x.dtype.name)
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_reference_matches_jax_kernel(case):
    """Same q, k, v, do and the same o, lse (from the JAX forward kernel) into
    both backward functions, in the folded layout."""
    B, S, H, KVH, D, causal, dtype = case
    rng = np.random.default_rng(17)
    qj, qt = _pair(rng, (B, S, H, D), dtype)
    kj, kt = _pair(rng, (B, S, KVH, D), dtype)
    vj, vt = _pair(rng, (B, S, KVH, D), dtype)
    doj, dot = _pair(rng, (B, S, H, D), dtype)
    scale = D**-0.5
    fold = (jops._fold(qj, KVH), jops._kv_fold(kj), jops._kv_fold(vj))
    o_j, lse_j = jfa.flash_attention_fwd(*fold, causal=causal, scale=scale, block_q=16, block_k=32,
                                         interpret=True)
    want = jfa.flash_attention_bwd(*fold, o_j, lse_j, jops._fold(doj, KVH), causal=causal, scale=scale,
                                   block_q=16, block_k=32, interpret=True)
    args = (tops._fold(qt, KVH), tops._kv_fold(kt), tops._kv_fold(vt), _to_torch(o_j), _to_torch(lse_j),
            tops._fold(dot, KVH))
    got = tref.flash_attention_bwd_reference(*args, causal=causal, scale=scale)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    via_wrapper = tfa.flash_attention_bwd(*args, causal=causal, scale=scale)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, args[:3]):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **_tol(dtype))
    for a, b in zip(got, via_wrapper):
        assert torch.equal(a, b)
    assert (tfa.dkv_launch_count, tfa.dq_launch_count) == (0, 0)


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1] == "float32"])
def test_ops_flash_attention_grads_match_jax_grad(case):
    """Twin of test_flash_bwd_matches_oracle: the port's autograd against
    jax.grad of the reference's custom_vjp, loss sum(sin(o))."""
    B, S, H, KVH, D, causal, _ = case
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng, (B, S, H, D))
    kj, kt = _pair(rng, (B, S, KVH, D))
    vj, vt = _pair(rng, (B, S, KVH, D))

    def loss_jax(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, block_q=16, block_k=32, mode="interpret")
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss_jax, (0, 1, 2))(qj, kj, vj)
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    o = tops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(o.sin().sum(), leaves)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-4, rtol=5e-4, err_msg=name)


RAGGED_CASES = [
    # (B, Sq, Skv, H, KVH, D, causal, q_offset): lengths no block divides, and
    # the q_offset that the reference's _flash_bwd never forwards
    (2, 37, 37, 8, 2, 16, True, 0),
    (1, 20, 50, 6, 2, 16, True, 30),
    (1, 21, 33, 4, 4, 8, False, 0),
    (2, 13, 29, 16, 2, 32, True, 16),
]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ops_flash_attention_grads_at_ragged_lengths(case):
    """Against torch autograd through the naive mha_reference."""
    B, Sq, Skv, H, KVH, D, causal, q_offset = case
    rng = np.random.default_rng(5)
    _, qt = _pair(rng, (B, Sq, H, D))
    _, kt = _pair(rng, (B, Skv, KVH, D))
    _, vt = _pair(rng, (B, Skv, KVH, D))
    _, dot = _pair(rng, (B, Sq, H, D))
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    o = tops.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad(o, leaves, dot)
    o_ref = tref.mha_reference(*leaves, causal=causal, q_offset=q_offset)
    want = torch.autograd.grad(o_ref, leaves, dot)
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=2e-5, rtol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-4, rtol=5e-4, err_msg=name)


def test_bwd_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 8, 2, 16)
    k = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8, 2)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, k, q, lse[..., :1], q, causal=True, scale=1.0)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, k, k, q, lse.double(), q, causal=True, scale=1.0)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, k, q, lse, q[:, :, :4], causal=True, scale=1.0)


# ---------------------------------------------------------------------------
# the backward kernels' tile plan and the checks their launches make (the
# kernels themselves run on the card only, held by chip_smoke.py)
# ---------------------------------------------------------------------------

from repro_torch.configs.registry import ASSIGNED  # noqa: E402

REGISTRY_G_D = sorted({(c.n_heads // c.n_kv_heads, c.resolved_head_dim) for c in ASSIGNED.values()
                       if c.family in ("dense", "vlm", "moe") and c.resolved_head_dim in tfa.HEAD_DIMS})


def test_registry_g_d_pairs_cover_the_issue_list():
    # stablelm-12b's head_dim 160 is built since the kernels take three column blocks a row
    assert {g for g, _ in REGISTRY_G_D} >= {1, 4, 7, 8} and {d for _, d in REGISTRY_G_D} == {64, 128, 160}


@pytest.mark.parametrize("rows", [tfa.DQ_TILE_ROWS, tfa.DKV_TILE_ROWS])
@pytest.mark.parametrize("g_d", REGISTRY_G_D + [(3, 64), (130, 64), (130, 160)])
def test_tile_plan_gives_a_legal_tma_box(g_d, rows):
    """The box a tensor map takes: every dim 1..256, 64 16-bit elements (one
    128-byte swizzle atom) innermost, at most ``rows`` rows, and as many whole
    positions as fit. A row of D takes ceil(D / 64) boxes; where 64 does not
    divide D (160) the last box reaches past D, and the tensor map's extent
    of D clips it, by at most half a box."""
    G, D = g_d
    plan = tfa.tile_plan(G, rows)
    assert plan == tfa.tile_plan(G, rows)  # a function of the shapes alone
    assert all(1 <= n <= 256 for n in plan.box) and plan.box[0] * 2 == 128
    n_boxes = -(-D // plan.box[0])
    assert 0 <= n_boxes * plan.box[0] - D <= plan.box[0] // 2
    assert plan.rows_used == plan.positions * plan.groups <= rows
    assert plan.rows_masked == rows - plan.rows_used
    if G <= rows:
        assert (plan.groups, plan.g_chunks) == (G, 1) and rows - plan.rows_used < G
    else:
        assert (plan.positions, plan.groups) == (1, rows) and plan.g_chunks * rows >= G > (plan.g_chunks - 1) * rows


@pytest.mark.parametrize("Sq", [1, 37, 100])
@pytest.mark.parametrize("G", [1, 3, 4, 7, 8, 130])
@pytest.mark.parametrize("rows", [tfa.DQ_TILE_ROWS, tfa.DKV_TILE_ROWS])
def test_tile_plan_covers_every_folded_row_once(G, Sq, rows):
    """The kernels' map from (tile, local row) to (position, group), run in
    Python: every (position, group) of q lands in exactly one tile row."""
    plan = tfa.tile_plan(G, rows)
    seen = []
    for tile in range(plan.n_tiles(Sq)):
        pos0, g0 = (tile // plan.g_chunks) * plan.positions, (tile % plan.g_chunks) * plan.groups
        for lr in range(rows):
            pos, g = pos0 + lr // plan.groups, g0 + lr % plan.groups
            if lr < plan.rows_used and pos < Sq and g < G:
                seen.append((pos, g))
    assert sorted(seen) == [(p, g) for p in range(Sq) for g in range(G)]


def dkv_by_blocks(q, k, v, o, lse, do, *, causal, scale, q_offset):
    """K2's sweep in float64: q, o, do (B,KVH,Sq,G,D), k, v (B,KVH,Skv,D). A
    block owns ``dkv_kv_rows(D)`` KV rows and sweeps the q tiles of
    ``DKV_TILE_ROWS`` folded rows from the first one that reaches it. Its two
    warpgroups take 64 rows each, or (D = 160) the same 64 rows, one their dv
    and the other their dk. A warpgroup skips a tile wholly before its rows
    and masks one only where it meets the diagonal. Returns (dk, dv, writes
    of dk, writes of dv)."""
    B, KVH, Sq, G, D = q.shape
    Skv = k.shape[2]
    plan = tfa.tile_plan(G, tfa.DKV_TILE_ROWS)
    own = tfa.dkv_kv_rows(D)
    split = own == 64
    delta = (o * do).sum(-1)
    n_pad = -(-Skv // own) * own
    kp, vp = np.zeros((B, KVH, n_pad, D)), np.zeros((B, KVH, n_pad, D))
    kp[:, :, :Skv], vp[:, :, :Skv] = k, v
    dk, dv = np.full(k.shape, np.nan), np.full(v.shape, np.nan)
    wk, wv = np.zeros(Skv, dtype=int), np.zeros(Skv, dtype=int)
    n_pt = -(-Sq // plan.positions)
    for kv0 in range(0, Skv, own):
        pt_begin = min(n_pt, (kv0 - q_offset) // plan.positions) if causal and kv0 > q_offset else 0
        for wg in range(2):
            kv_w = kv0 + (0 if split else 64 * wg)
            rows = kv_w + np.arange(64)
            acc_k, acc_v = np.zeros((B, KVH, 64, D)), np.zeros((B, KVH, 64, D))
            for tile in range(pt_begin * plan.g_chunks, n_pt * plan.g_chunks):
                pos0, g0 = (tile // plan.g_chunks) * plan.positions, (tile % plan.g_chunks) * plan.groups
                first = q_offset + pos0
                if causal and first + plan.positions - 1 < kv_w:
                    continue
                for lr in range(plan.rows_used):
                    pos, g = pos0 + lr // plan.groups, g0 + lr % plan.groups
                    if pos >= Sq or g >= G:
                        continue
                    s = np.einsum("bhkd,bhd->bhk", kp[:, :, rows], q[:, :, pos, g]) * scale
                    p = np.exp(s - lse[:, :, pos, g, None])
                    if causal and first < kv_w + 63:
                        p = np.where(q_offset + pos >= rows, p, 0.0)
                    dp = np.einsum("bhkd,bhd->bhk", vp[:, :, rows], do[:, :, pos, g])
                    ds = p * (dp - delta[:, :, pos, g, None])
                    acc_v += p[..., None] * do[:, :, pos, g, None, :]
                    acc_k += ds[..., None] * q[:, :, pos, g, None, :]
            live = rows < Skv
            if not split or wg == 1:
                dk[:, :, rows[live]] = scale * acc_k[:, :, live]
                wk[rows[live]] += 1
            if not split or wg == 0:
                dv[:, :, rows[live]] = acc_v[:, :, live]
                wv[rows[live]] += 1
    return dk, dv, wk, wv


@pytest.mark.parametrize("case", [
    # (G, Sq, Skv, D, causal, q_offset)
    (4, 77, 77, 160, True, 0),     # three blocks of 64 kv rows, split between the warpgroups
    (1, 130, 131, 160, False, 0),
    (2, 40, 100, 160, True, 60),   # q_offset: blocks before the first position skip nothing
    (4, 77, 150, 64, True, 0),     # blocks of 128 kv rows, 64 a warpgroup
    (3, 50, 200, 128, True, 150),
])
def test_dkv_block_sweep_matches_plain_version(case):
    """Every kv row's dk and dv are written once, and the blocks' sweeps (the
    q tiles each visits, skips and masks) give the plain version's dk, dv."""
    G, Sq, Skv, D, causal, q_offset = case
    B, KVH = 1, 2
    rng = np.random.default_rng(11)
    q, do, o = (rng.standard_normal((B, KVH, Sq, G, D)) for _ in range(3))
    k, v = (rng.standard_normal((B, KVH, Skv, D)) for _ in range(2))
    scale = D**-0.5
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tref.mha_reference_with_lse(qt.permute(0, 2, 1, 3, 4).reshape(B, Sq, KVH * G, D),
                                         kt.permute(0, 2, 1, 3), vt.permute(0, 2, 1, 3),
                                         causal=causal, q_offset=q_offset, scale=scale)
    lse = lse.reshape(B, Sq, KVH, G).permute(0, 2, 1, 3).double()
    dk, dv, wk, wv = dkv_by_blocks(q, k, v, o, lse.numpy(), do, causal=causal, scale=scale, q_offset=q_offset)
    assert (wk == 1).all() and (wv == 1).all()
    _, dk_ref, dv_ref = tref.flash_attention_bwd_reference(qt, kt, vt, torch.from_numpy(o), lse,
                                                           torch.from_numpy(do), causal=causal, scale=scale,
                                                           q_offset=q_offset)
    np.testing.assert_allclose(dk, dk_ref.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dv, dv_ref.numpy(), atol=2e-5, rtol=2e-5)


def _bwd_tensors(D=64, dtype=torch.bfloat16):
    B, KVH, Sq, Skv, G = 1, 2, 8, 8, 2
    q = torch.zeros(B, KVH, Sq, G, D, dtype=dtype)
    k = torch.zeros(B, KVH, Skv, D, dtype=dtype)
    lse = torch.zeros(B, KVH, Sq, G)
    return dict(q=q, k=k, v=k.clone(), o=q.clone(), do=q.clone(), lse=lse, delta=lse.clone(), dq=q.clone(),
                dk=k.clone(), dv=k.clone())


def _faults():
    """(tensor, change, error): each change breaks one thing a launch checks;
    the last changes nothing."""
    def padded(x):  # rows D + 4 elements apart: not a multiple of 16 bytes
        return torch.zeros(*x.shape[:-1], x.shape[-1] + 4, dtype=x.dtype)[..., : x.shape[-1]]
    return [
        ("o", lambda t: t["o"][:, :, :4], ValueError),
        ("do", lambda t: t["do"].float(), TypeError),
        ("dq", lambda t: t["dq"].half(), TypeError),
        ("dk", lambda t: t["dk"][:, :1], ValueError),
        ("dv", lambda t: padded(t["dv"]), ValueError),
        ("do", lambda t: padded(t["do"]), ValueError),
        ("delta", lambda t: t["delta"][..., :1], ValueError),
        ("delta", lambda t: t["delta"].double(), ValueError),
        ("lse", lambda t: t["lse"].transpose(2, 3).contiguous().transpose(2, 3), ValueError),
        (None, None, None),
    ]


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("fault", range(len(_faults())))
def test_bwd_launches_check_their_inputs(which, fault):
    """Each launch raises on what its kernel cannot take, before any CUDA call
    (so here on CPU tensors), and a CPU tensor that passes every other check
    is refused last: the launches take CUDA tensors only."""
    name, change, error = _faults()[fault]
    t = _bwd_tensors()
    if name is not None:
        t[name] = change(t)
    kw = dict(causal=True, scale=0.125)
    launch = {"dq": lambda: tfa.launch_bwd_dq(t["q"], t["k"], t["v"], t["o"], t["do"], t["lse"], t["delta"],
                                              t["dq"], **kw),
              "dkv": lambda: tfa.launch_bwd_dkv(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"],
                                                t["dk"], t["dv"], **kw)}[which]
    used = {"dq": {"q", "k", "v", "o", "do", "lse", "delta", "dq"},
            "dkv": {"q", "k", "v", "do", "lse", "delta", "dk", "dv"}}[which]
    if name in used:
        with pytest.raises(error):
            launch()
    else:  # a change to a tensor this launch does not take, or none
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    assert (tfa.dq_launch_count, tfa.dkv_launch_count) == (0, 0)


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("bad", ["head_dim", "float32", "broadcast"])
def test_bwd_launches_refuse_what_the_kernels_do_not_take(which, bad):
    t = _bwd_tensors(D=32 if bad == "head_dim" else 64, dtype=torch.float32 if bad == "float32" else torch.bfloat16)
    if bad == "broadcast":  # a stride of 0 on a dim of 8 entries: TMA cannot step it
        t["q"] = t["q"][:, :, :1].expand(t["q"].shape)
    kw = dict(causal=False, scale=0.125)
    launch = {"dq": lambda: tfa.launch_bwd_dq(t["q"], t["k"], t["v"], t["o"], t["do"], t["lse"], t["delta"],
                                              t["dq"], **kw),
              "dkv": lambda: tfa.launch_bwd_dkv(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"],
                                                t["dk"], t["dv"], **kw)}[which]
    with pytest.raises((ValueError, TypeError), match="head_dim|bfloat16|layout"):
        launch()
