"""The plans of the flash forward kernel (K1) and the decode kernel (K4), and
the build cache of the kernels, on the CPU.

The CUDA kernels run on the card only (``chip_smoke.py`` holds them against
their plain versions there). What is held here is what decides which rows and
keys each block visits, run in Python: the tile plan of K1's folded q rows a
block (``fwd_tile_rows(D)``: 192 at D = 64 and 112, 128 at D = 128 and 160),
the KV tiles each of its consumer warpgroups (64 rows each, three at D = 64
and 112, two at D = 128 and 160)
sweeps, which tiles skip the mask; the tiles of the cache each block of K4's cluster takes, and
the combine of their partials. Each model is held against the plain version
(``kernels/ref.py``), which computes in f32, at the reference's f32 tolerance
(2e-5): a wrong bound or a wrongly skipped mask shows as an error of order
0.1, and every output row must be written exactly once.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

NEG_INF = -1e30


def kv_rows(D: int) -> int:
    """KV rows of a swept tile of K1 (``kv_rows<D>`` in csrc/flash_attention_fwd.cu)."""
    return 128 if D == 64 else 64


def fwd_by_tiles(q, k, v, *, causal, scale, q_offset):
    """K1's sweep in float64: q (B,KVH,Sq,G,D), k/v (B,KVH,Skv,D). A block
    owns ``fwd_tile_rows(D)`` folded rows, 64 a consumer warpgroup; each work
    item (q tile, kv head, batch) is swept alone, in whichever order. Returns
    (o, lse, writes): what the kernel stores and how often each (position,
    group) is stored. Rows past the tile's whole positions, past Sq or past G
    are never stored; keys past Skv read as 0 (TMA's fill) unless masked."""
    B, KVH, Sq, G, D = q.shape
    Skv = k.shape[2]
    plan = tfa.tile_plan(G, tfa.fwd_tile_rows(D))
    NK = kv_rows(D)
    o = np.full(q.shape, np.nan)
    lse = np.full((B, KVH, Sq, G), np.nan)
    writes = np.zeros((B, KVH, Sq, G), dtype=int)
    n_pad = -(-Skv // NK) * NK
    kp = np.zeros((B, KVH, n_pad, D))
    vp = np.zeros((B, KVH, n_pad, D))
    kp[:, :, :Skv], vp[:, :, :Skv] = k, v
    for tile in range(plan.n_tiles(Sq)):
        pos0, g0 = (tile // plan.g_chunks) * plan.positions, (tile % plan.g_chunks) * plan.groups
        kv_end = min(Skv, q_offset + min(pos0 + plan.positions, Sq)) if causal else Skv
        n_kt = -(-kv_end // NK) if kv_end > 0 else 0
        for wg in range(plan.rows // 64):
            rows = min(64, plan.rows_used - 64 * wg)
            last = q_offset + pos0 + (64 * wg + rows - 1) // plan.groups
            n_live = 0 if rows <= 0 else (min(n_kt, max(0, last + NK) // NK) if causal else n_kt)
            first = q_offset + pos0 + (64 * wg) // plan.groups
            for lr in range(64 * wg, 64 * wg + 64):
                pos, g = pos0 + lr // plan.groups, g0 + lr % plan.groups
                if not (lr < plan.rows_used and pos < Sq and g < G):
                    continue
                kv_last = min(Skv, q_offset + pos + 1) - 1 if causal else Skv - 1
                for b in range(B):
                    for h in range(KVH):
                        m, l, acc = NEG_INF, 0.0, np.zeros(D)
                        for it in range(n_live):
                            kv = np.arange(it * NK, (it + 1) * NK)
                            s = kp[b, h, kv] @ q[b, h, pos, g]
                            if (it + 1) * NK > Skv or (causal and (it + 1) * NK - 1 > first):
                                s = np.where(kv <= kv_last, s, NEG_INF)
                            mn = max(m, s.max())
                            corr = math.exp((m - mn) * scale)
                            c = 0.0 if mn == NEG_INF else scale
                            p = np.exp(s * c - mn * c)
                            l, acc, m = l * corr + p.sum(), acc * corr + p @ vp[b, h, kv], mn
                        o[b, h, pos, g] = acc / max(l, 1e-30)
                        lse[b, h, pos, g] = (NEG_INF if m == NEG_INF else m * scale) + math.log(max(l, 1e-30))
                        writes[b, h, pos, g] += 1
    return o, lse, writes


FWD_CASES = [
    # (G, Sq, Skv, D, causal, q_offset)
    (1, 300, 300, 64, True, 0),    # 192 positions a tile: the warpgroups sweep different tile counts
    (3, 100, 100, 64, True, 0),    # 64 positions a tile
    (3, 100, 100, 128, True, 0),   # 42 positions a tile, 2 rows zeroed
    (4, 77, 77, 128, True, 0),     # 64-row kv tiles, ragged
    (4, 1, 1, 64, True, 0),
    (8, 50, 131, 64, False, 0),    # non-causal, ragged Skv
    (8, 33, 97, 64, True, 64),     # q_offset > 0
    (130, 5, 40, 64, True, 35),    # one position a tile, 62 rows zeroed
    (130, 5, 40, 128, True, 35),   # the heads of one position over two tiles
    (4, 77, 77, 160, True, 0),     # head_dim 160: 64-row kv tiles, 32 positions a tile
    (1, 130, 131, 160, False, 0),  # head_dim 160, G=1, non-causal, ragged Skv
    (130, 5, 40, 160, True, 35),   # head_dim 160: the heads of one position over two tiles
    (1, 300, 300, 112, True, 0),   # head_dim 112 (zamba2-7b), G=1: 192 positions a tile
    (4, 77, 77, 112, True, 0),     # head_dim 112: 64-row kv tiles, 48 positions a tile
    (1, 130, 131, 112, False, 0),  # head_dim 112, non-causal, ragged Skv
    (130, 5, 40, 112, True, 35),   # head_dim 112: the heads of one position over two tiles
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_tile_sweep_matches_plain_version(case):
    """Every folded row is written once, and the sweep (the tiles each
    warpgroup visits, the tiles it masks) gives the plain version's o and lse."""
    G, Sq, Skv, D, causal, q_offset = case
    B, KVH = 1, 2
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, KVH, Sq, G, D))
    k = rng.standard_normal((B, KVH, Skv, D))
    v = rng.standard_normal((B, KVH, Skv, D))
    scale = D**-0.5
    o, lse, writes = fwd_by_tiles(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    assert (writes == 1).all()
    qt = torch.from_numpy(q).permute(0, 2, 1, 3, 4).reshape(B, Sq, KVH * G, D)
    o_ref, lse_ref = tref.mha_reference_with_lse(
        qt, torch.from_numpy(k).permute(0, 2, 1, 3), torch.from_numpy(v).permute(0, 2, 1, 3),
        causal=causal, q_offset=q_offset, scale=scale)
    o_ref = o_ref.reshape(B, Sq, KVH, G, D).permute(0, 2, 1, 3, 4).numpy()
    lse_ref = lse_ref.reshape(B, Sq, KVH, G).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(o, o_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse, lse_ref, atol=2e-5, rtol=2e-5)


def test_fwd_tiles_at_head_dim_160():
    """D = 160 (stablelm-12b) takes D = 128's tiles: two consumer warpgroups,
    128 folded rows a block, 64-row KV tiles; a row is three 64-element
    column blocks, the last half past D."""
    assert tfa.fwd_tile_rows(160) == tfa.fwd_tile_rows(128) == 128
    assert kv_rows(160) == kv_rows(128) == 64
    assert 160 in tfa.HEAD_DIMS and 160 in tda.HEAD_DIMS and 160 in tfa.BWD_HEAD_DIMS


def test_fwd_tiles_at_head_dim_112():
    """D = 112 (zamba2-7b): a row is two 64-element column blocks, the last 16
    columns of the second past D; three consumer warpgroups (192 folded rows)
    as at D = 64, over D = 128's 64-row KV tiles. K1 and K4 take it; the
    backward kernels do not, and say so before any CUDA call."""
    assert tfa.fwd_tile_rows(112) == tfa.fwd_tile_rows(64) == 192
    assert kv_rows(112) == kv_rows(128) == 64
    assert tfa.HEAD_DIMS == tda.HEAD_DIMS == (64, 112, 128, 160)
    assert tfa.BWD_HEAD_DIMS == (64, 128, 160)
    q = torch.zeros(1, 2, 8, 1, 112, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 8, 112, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, 1)
    with pytest.raises(ValueError, match=r"backward kernels are built for head_dim \(64, 128, 160\), not 112"):
        tfa.launch_bwd_dq(q, k, k, q, q, lse, lse.clone(), q.clone(), causal=True, scale=112**-0.5)
    assert tfa.dq_launch_count == 0


@pytest.mark.parametrize("D", [64, 112, 128, 160])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 130, 200])
def test_fwd_tile_plan_box_and_items(G, D):
    """The forward's plan: 64 rows a consumer warpgroup, whole positions (or
    the heads of one position over several tiles), a box TMA takes, and the
    work items it makes."""
    rows = tfa.fwd_tile_rows(D)
    assert rows in (128, 192) and rows % 64 == 0
    plan = tfa.tile_plan(G, rows)
    assert plan == tfa.tile_plan(G, rows)  # a function of the shapes alone
    assert plan.rows == rows and plan.rows_used <= plan.rows
    assert all(1 <= n <= 256 for n in plan.box) and plan.box[0] == 64
    if G <= plan.rows:
        assert plan.g_chunks == 1 and plan.rows_masked < G
    else:
        assert plan.positions == 1 and plan.g_chunks == -(-G // plan.rows)
    assert plan.n_tiles(2048) == -(-2048 // plan.positions) * plan.g_chunks


def test_fwd_refuses_layouts_its_tensor_maps_cannot_step():
    """A broadcast q (stride 0 on a dim of several entries) is refused before
    any CUDA call; a CPU tensor of the same layout takes the plain version."""
    q = torch.zeros(1, 2, 8, 1, 64, dtype=torch.bfloat16).expand(1, 2, 8, 4, 64)
    k = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="layout"):
        tfa._check_tma(q=q, k=k, v=k)
    o, lse = tfa.flash_attention_fwd(q, k, k, causal=True, scale=0.125)
    assert o.shape == q.shape and lse.shape == (1, 2, 8, 4) and tfa.launch_count == 0


# ---------------------------------------------------------------------------
# K4: the tiles of one cluster's blocks, and the combine
# ---------------------------------------------------------------------------

#: cache rows of one TMA tile of K4 (``R`` in csrc/decode_attention.cu: 16 a warp)
TILE_ROWS = 64


def split_rows(Smax: int, ns: int):
    """The cache rows each block of a cluster of ``ns`` sweeps when kv_len is
    Smax: block j takes the tiles j, j + ns, j + 2 ns, ... A shorter kv_len
    drops the tiles past it and masks the tail of the last one."""
    n_tiles = -(-Smax // TILE_ROWS)
    return [[r for t in range(j, n_tiles, ns) for r in range(t * TILE_ROWS, min((t + 1) * TILE_ROWS, Smax))]
            for j in range(ns)]


def decode_by_cluster(q, kc, vc, kv_len, *, scale, n_sm=132):
    """K4's split in float64: q (B,H,D), caches (B,Smax,KVH,D). Block j of a
    cluster of ``n_splits`` takes the tiles j, j + ns, ... below kv_len, runs
    an online softmax over them, and the partials are combined as the kernel
    combines them. Returns (out, rows seen per (b, head))."""
    B, H, D = q.shape
    _, Smax, KVH, _ = kc.shape
    G = H // KVH
    ns = tda.n_splits(B, KVH, G, Smax, n_sm)
    R = TILE_ROWS
    n_all = -(-kv_len // R)
    out = np.zeros(q.shape)
    seen = np.zeros((B, H), dtype=int)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            parts = []
            for j in range(ns):
                m, l, acc = NEG_INF, 0.0, np.zeros(D)
                for t in range(j, n_all, ns):
                    rows = np.arange(t * R, (t + 1) * R)
                    rows = rows[rows < kv_len]
                    seen[b, h] += len(rows)
                    s = kc[b, rows, kvh] @ q[b, h] * scale
                    mn = max(m, s.max())
                    p = np.exp(s - mn)
                    l, acc, m = l * math.exp(m - mn) + p.sum(), acc * math.exp(m - mn) + p @ vc[b, rows, kvh], mn
                parts.append((m, l, acc))
            mt = max(m for m, _, _ in parts)
            lt = sum(math.exp(m - mt) * l for m, l, _ in parts)
            at = sum(math.exp(m - mt) * a for m, _, a in parts)
            out[b, h] = at / max(lt, 1e-30)
    return out, seen


DECODE_CASES = [
    # (B, Smax, H, KVH, D, kv_len): chip_smoke.py's cases, smaller where they are large
    (2, 333, 8, 2, 160, 77),    # head_dim 160
    (2, 333, 4, 4, 112, 77),    # head_dim 112, G=1: one live head in a block's 8
    (8, 2080, 4, 4, 112, 2049),  # zamba2's decode length, four of its 32 heads
    (2, 333, 8, 2, 64, 1),
    (2, 333, 8, 2, 64, 77),
    (2, 333, 8, 2, 64, 333),
    (3, 97, 6, 1, 128, 50),
    (1, 515, 16, 2, 64, 300),
    (1, 2080, 4, 1, 64, 2064),  # the serving length: a cluster of 8 blocks
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_cluster_split_matches_plain_version(case):
    B, Smax, H, KVH, D, kv_len = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, D))
    kc = rng.standard_normal((B, Smax, KVH, D))
    vc = rng.standard_normal((B, Smax, KVH, D))
    out, seen = decode_by_cluster(q, kc, vc, kv_len, scale=D**-0.5)
    assert (seen == kv_len).all()  # every row below kv_len once, none past it
    want = tref.decode_attention_reference(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                           kv_len=kv_len, scale=D**-0.5)
    np.testing.assert_allclose(out, want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Smax", [1, 63, 64, 65, 333, 2080, 4097])
@pytest.mark.parametrize("n_sm", [132, 16])
def test_decode_split_rows_cover_the_cache_once(Smax, n_sm):
    """The blocks of a cluster take every cache row 0..Smax-1 exactly once,
    their shares differ by one tile at most, and the split is the shapes'."""
    for B, KVH, G in ((8, 8, 4), (1, 1, 1), (2, 2, 8), (1, 8, 4), (64, 8, 4)):
        ns = tda.n_splits(B, KVH, G, Smax, n_sm)
        assert ns == tda.n_splits(B, KVH, G, Smax, n_sm)
        assert 1 <= ns <= tda.MAX_SPLITS and ns & (ns - 1) == 0
        split = split_rows(Smax, ns)
        assert sorted(r for rows in split for r in rows) == list(range(Smax))
        sizes = [len(rows) for rows in split]
        assert max(sizes) - min(sizes) <= TILE_ROWS


# ---------------------------------------------------------------------------
# the build cache: a library's name hashes its source and the headers it includes
# ---------------------------------------------------------------------------


def test_build_target_hashes_every_included_header(tmp_path):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  # include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    src = tmp_path / "a.cu"
    assert _build.headers(src) == [(tmp_path / "h.cuh").resolve(), (tmp_path / "g.cuh").resolve()]
    assert _build.headers(tmp_path / "b.cu") == []
    before = _build._target(src)
    assert _build._target(src) == before  # unchanged sources: the same library
    (tmp_path / "g.cuh").write_text("// two\n")  # a header included through another
    assert _build._target(src) != before
    assert _build._target(tmp_path / "b.cu").name.startswith("libb-")


def test_kernel_sources_include_the_shared_header():
    names = {src.stem: [h.name for h in _build.headers(src)] for src in _build.sources()}
    for name in ("flash_attention_fwd", "flash_attention_bwd", "decode_attention"):
        assert names[name] == ["hopper.cuh"]
    assert all(src.suffix == ".cu" for src in _build.sources())
