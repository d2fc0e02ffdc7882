"""The sharded steps do the reference's per-device work in the dry-run cells
whose work used to run whole on every rank: the prefill step's MLP,
attention where ``model`` does not divide the query heads, and rwkv6's
time-mix projections and, at batch 1, its channel mix's receptance product.

  * FLOPs a device of the port's ``run_cell`` against the reference's on 256
    XLA host devices (one subprocess, which runs while this process lowers
    the port's cells, as ``test_torch_shard_fidelity.py`` runs it), at 16 x 16:
    granite-3-2b prefill_32k, whisper-base decode_32k, rwkv6-1.6b
    decode_32k and long_500k within ``TOL_FULL``; whisper-base train_4k at most
    ``TOL_FULL`` above the reference, and at 1/256 of the port's own whole
    step (the same step lowered on a 1 x 1 mesh) within ``TOL_FULL``: the
    reference's program computes each head's score products on both ranks
    of the head's group and the port does not (PERF.md), so the port reads
    below it there; and there no all-gather of a layer's whole q, k or v;
  * ``dist.row_split`` on emulated ranks in one process: the shares cover
    every (query head, row) pair once, a causal attention's zig-zag shares
    carry equal live pairs, and the flash kernel's plain version on each
    rank's share (its heads on its slices of the rows, ``q_offset`` moved
    with each) equals the whole call, outputs and summed gradients, causal
    and not; the exchange that takes the shares' output to ``wo``'s row
    layout (``ops.RowShareExchange.to_cols``) lands each rank's block of the
    whole output, and its inverse each share of the gradient; the decode on
    each rank's heads and cache rows, merged, equals the whole decode;
  * the shares' inputs from the projections' column blocks, bit for bit:
    q's share by ``to_rows`` (and back by ``to_cols``), the KV heads it
    reads by ``ops.KvToShare`` (its backward summing each reader's gradient
    into the owner's block), RoPE on a share against RoPE on the whole
    tensor sliced, and prefill's cache rows from each rank's own block.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, lowering
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.sharding import dist

ROOT = Path(__file__).resolve().parent.parent
#: port / reference - 1 at 16 x 16. Read: granite prefill_32k 0.0%, whisper
#: decode_32k 0.0%, rwkv6 decode_32k 0.0% (3.58x, 1.99x and 3.01x with the
#: MLP, the cross attention and the time mix whole on every rank), rwkv6
#: long_500k 0.0%, 12,451,840 FLOPs on both sides (2.13x with the channel
#: mix's receptance product whole on ``model``); whisper train_4k -18.9% (7.68x)
TOL_FULL = 0.05
CELLS = (("granite-3-2b", "prefill_32k"), ("whisper-base", "train_4k"), ("whisper-base", "decode_32k"),
         ("rwkv6-1.6b", "decode_32k"), ("rwkv6-1.6b", "long_500k"))
#: the cell whose reference program repeats work that the port splits
BELOW = ("whisper-base", "train_4k")
#: bf16's tolerance of the reference's kernel tests, for outputs rounded to bf16
TOL_BF16 = 2e-2

_REFERENCE = """
    import json, sys
    from pathlib import Path
    from repro.launch import dryrun

    out = Path(sys.argv[1])
    found = {"/".join(c): dryrun.run_cell(*c, "single", out)["roofline"] for c in json.loads(sys.argv[2])}
    (out / "reference.json").write_text(json.dumps(found))
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while these tests run: the suite's workers share
    the host's cores, and the lowerings and emulations are many small ops."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """``{"ref": ..., "port": ..., "whole": ...}``: each cell's roofline
    record on both sides (keyed ``arch/shape``), and the FLOPs of ``BELOW``'s
    step lowered on a 1 x 1 mesh."""
    ref_dir, port_dir = tmp_path_factory.mktemp("reference"), tmp_path_factory.mktemp("port")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=256")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(ref_dir), json.dumps(CELLS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = {"/".join(c): dryrun.run_cell(*c, "single", port_dir)["roofline"] for c in CELLS}
        with lowering.fake_world(1):
            mesh = make_mesh_shape((1, 1), ("data", "model"), device="cpu")
            whole = lowering.lower_cell(BELOW[0], SHAPES_BY_NAME[BELOW[1]], mesh)[2].flops
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return {"ref": json.loads((ref_dir / "reference.json").read_text()), "port": port, "whole": whole}


@pytest.mark.parametrize("cell", ["/".join(c) for c in CELLS])
def test_flops_a_device_match_the_reference(counts, cell):
    ref, port = counts["ref"][cell], counts["port"][cell]
    assert (port["mesh"], ref["mesh"]) == ("16x16", "16x16")
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    if cell == "/".join(BELOW):
        assert ratio <= 1 + TOL_FULL, (cell, ratio)
    else:
        assert abs(ratio - 1) <= TOL_FULL, (cell, ratio)


def test_each_device_does_its_share_of_the_whole_step(counts):
    """whisper-base train_4k: 256 devices each do 1/256 of the step's
    FLOPs, within ``TOL_FULL`` (read: 1.000); before the row split each did
    7.68x the reference's."""
    got = counts["port"]["/".join(BELOW)]["flops_per_device"] * 256
    assert abs(got / counts["whole"] - 1) <= TOL_FULL, (got, counts["whole"])


def test_no_row_share_input_is_gathered_whole(counts):
    """whisper-base train_4k, whose 8 heads ``model`` (16) does not divide:
    the row shares take q, k and v from the projections' column blocks, so
    no all-gather of a layer's whole q, k or v is left, forward or backward
    (the decoder's self and cross q, k, v and the encoder's, each a layer,
    4.70 GB of the 11.69 GB of raw all-gathers before; read 6.99). A
    device's shapes: batch 16, 4096 rows, H·D = d_model = 512, the vocab
    padded to 51,872, 87,729,152 parameters. The one all-gather in
    ``top_ops`` as large as a layer's q is the loss's logits over the vocab,
    which ``model`` does not divide either; and the raw all-gathers sit
    under the logits', the decoder embedding's output (B, S, d) and its
    gradient brought whole on d by the plan's ``hidden`` spec, and every
    parameter once in bf16: 7.11 GB."""
    B, S, d, vocab, params = 16, 4096, 512, 51_872, 87_729_152
    q_whole, logits = B * S * d * 2, B * S * vocab * 2  # 67,108,864 and 6,798,966,784 bytes
    record = counts["port"]["/".join(BELOW)]["collective_detail"]
    large = [op["bytes"] for op in record["top_ops"] if op["kind"] == "all-gather" and op["bytes"] >= q_whole]
    assert large == [logits], record["top_ops"]
    raw = record["by_kind"]["all-gather"]["raw_bytes"]
    assert raw < logits + 2 * q_whole + 2 * params, raw


# ---------------------------------------------------------------------------
# the row split, on emulated ranks
# ---------------------------------------------------------------------------


class _Mesh:
    """What ``dist.row_split`` reads of a ``DeviceMesh``: the names, the
    shape and this rank's coordinate on ``model``."""

    def __init__(self, tp: int, rank: int):
        self.mesh_dim_names, self.mesh, self.rank = ("data", "model"), torch.empty(1, tp), rank

    def get_local_rank(self, name):
        assert name == "model"
        return self.rank


#: (query heads, KV heads, model ranks): whisper-base at 16, llava-next-34b
#: at 16, the reduced configs of the 2 x 4 family files, a head count prime
#: to the ranks
SPLITS = [(8, 8, 16), (56, 8, 16), (14, 2, 4), (6, 6, 4), (7, 7, 4)]


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS)
@pytest.mark.parametrize("rows", [32, 23])
def test_row_split_shares_cover_the_work_once(heads, kv_heads, tp, rows):
    """Contiguous parts of the rows and, under a causal mask, the zig-zag."""
    cover = np.zeros((2, heads, rows), dtype=int)
    for rank in range(tp):
        share = dist.row_split(_Mesh(tp, rank), heads, kv_heads)
        for causal in (False, True):
            for r in share.rows(rows, causal=causal):
                cover[int(causal), share.heads, r] += 1
        picked = share.kv if isinstance(share.kv, list) else list(range(kv_heads))[share.kv]
        local_group = (share.heads.stop - share.heads.start) // len(picked)
        group = heads // kv_heads
        # query head j of the share reads local KV head j // local_group, which is KV head h // G
        assert [picked[j // local_group] for j in range(share.heads.stop - share.heads.start)] == \
            [h // group for h in range(share.heads.start, share.heads.stop)]
    assert (cover == 1).all()
    assert dist.row_split(_Mesh(16, 0), 32, 8).parts == 1  # model divides the heads: whole heads, every row
    assert dist.row_split(_Mesh(1, 0), 7, 7) is None  # one rank


def _live_pairs(rows, q_offset: int, keys: int) -> int:
    """The query x key pairs that a causal mask leaves of ``rows`` query rows
    from row ``q_offset`` over ``keys`` keys: row i sees min(i + 1, keys)."""
    return sum(min(q_offset + i + 1, keys) for i in range(rows))


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS)
@pytest.mark.parametrize("rows", [32, 23])
def test_causal_row_shares_carry_equal_live_pairs(heads, kv_heads, tp, rows):
    """The live pairs of each part of a group, counted from its slices' rows
    and ``q_offset`` (each slice a kernel call from its first row): equal
    where 2·parts divides the rows; elsewhere the busiest part exceeds the
    mean by at most one row's pairs (the last row's, ``rows``). A contiguous
    split gives the second of two parts 3x the first's."""
    pairs = {}
    for rank in range(tp):
        share = dist.row_split(_Mesh(tp, rank), heads, kv_heads)
        if share.heads.start == 0:  # the first group's parts
            pairs[share.part] = sum(_live_pairs(r.stop - r.start, r.start, rows)
                                    for r in share.rows(rows, causal=True))
    assert sorted(pairs) == list(range(share.parts)) and share.parts > 1
    assert sum(pairs.values()) == _live_pairs(rows, 0, rows)
    mean = sum(pairs.values()) / len(pairs)
    if rows % (2 * share.parts) == 0:
        assert len(set(pairs.values())) == 1, pairs
    assert max(pairs.values()) - mean <= rows, pairs
    if share.parts == 2:
        first, second = (_live_pairs(r.stop - r.start, r.start, rows) for r in
                         (share.rows(rows, p)[0] for p in range(2)))
        assert second > 2.5 * first  # the contiguous halves the zig-zag replaces


def _rand(gen, *shape):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("heads,kv_heads,tp", [(8, 8, 16), (14, 2, 4), (20, 5, 8)])
@pytest.mark.parametrize("causal,sq,skv", [(True, 32, 32), (True, 23, 23), (False, 32, 32), (False, 23, 23),
                                           (False, 16, 12)])
def test_flash_on_each_ranks_share_equals_the_whole_call(heads, kv_heads, tp, causal, sq, skv):
    """The flash kernel's plain version on each rank's share
    (``ops.flash_on_share``, as the sharded steps call it), one call a slice
    of its rows (the zig-zag's two under a causal mask, each from its first
    row), outputs placed where the slices lie, dq likewise and dk, dv summed
    over the ranks that read each KV head, against the whole call: self
    attention, causal and not, with rows that the parts divide and rows they
    do not, and a cross attention of 16 query rows over 12 keys. (20, 5, 8):
    a group whose query heads read KV heads unevenly (a list ``share.kv``)."""
    gen = np.random.default_rng(sq + heads)
    B, D = 2, 16
    q, do = _rand(gen, B, sq, heads, D), _rand(gen, B, sq, heads, D)
    k, v = _rand(gen, B, skv, kv_heads, D), _rand(gen, B, skv, kv_heads, D)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal)
    want = [o, *torch.autograd.grad(o, leaves, do)]
    got = [torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)]
    for rank in range(tp):
        share = dist.row_split(_Mesh(tp, rank), heads, kv_heads)
        picked, (lo, hi) = share.rows(sq, causal=causal), share.kv_span()
        ql, dol = (torch.cat([x[:, r, share.heads] for r in picked], dim=1) for x in (q, do))
        ql, kl, vl = (x.clone().requires_grad_() for x in (ql, k[:, :, lo:hi], v[:, :, lo:hi]))
        ol, _ = ops.flash_on_share(ql, kl, vl, share, picked, causal)
        dql, dkl, dvl = torch.autograd.grad(ol, (ql, kl, vl), dol)
        row = 0
        for r in picked:
            n = r.stop - r.start
            got[0][:, r, share.heads] = ol.detach()[:, row:row + n]
            got[1][:, r, share.heads] = dql[:, row:row + n]
            row += n
        got[2][:, :, lo:hi] += dkl
        got[3][:, :, lo:hi] += dvl
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _all_to_all(sent):
    """An all-to-all over emulated ranks: ``sent[k]`` is rank k's (buffer,
    sizes sent to each rank, sizes received from each rank); rank j receives
    each rank's chunk for it, in rank order."""
    offsets = [np.cumsum([0] + to_each[:-1]) for _, to_each, _ in sent]
    received = []
    for j, (_, _, from_each) in enumerate(sent):
        chunks = [buf[offsets[k][j]:offsets[k][j] + to_each[j]] for k, (buf, to_each, _) in enumerate(sent)]
        assert [c.numel() for c in chunks] == from_each  # what each rank sends is what the receiver expects
        received.append(torch.cat(chunks))
    return received


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS)
@pytest.mark.parametrize("causal,rows", [(True, 32), (True, 23), (False, 23), (True, 5)])
def test_row_shares_reach_wos_rows_by_one_exchange(heads, kv_heads, tp, causal, rows):
    """``ops.RowShareExchange.to_cols`` on emulated ranks: each rank packs
    its share of the whole output (its heads on its slices of the rows), the
    all-to-all runs over the ranks, and each rank's unpacked block is the
    whole output's ``wo`` block t, (B, S, H·D)[..., t·C:(t+1)·C]: 1/tp of the
    output, where the gather it replaces gave each rank all of it. The
    backward's exchange (``to_rows``), from each rank's block of a gradient,
    gives back each share of it.
    Rows 5 are fewer than 2·parts where parts is 4: the contiguous parts."""
    gen = np.random.default_rng(rows + heads)
    B, D = 2, 16
    whole, grad = _rand(gen, B, rows, heads, D), _rand(gen, B, rows, heads * D)
    shares = [dist.row_split(_Mesh(tp, rank), heads, kv_heads) for rank in range(tp)]
    exchanges = [ops.RowShareExchange(share, rows, heads, D, tp, causal) for share in shares]
    C = heads * D // tp

    def own(share):
        return torch.cat([whole[:, r, share.heads] for r in share.rows(rows, causal=causal)], dim=1)

    sent = [(ex.pack_rows(own(sh)), *ex.splits(B)) for ex, sh in zip(exchanges, shares)]
    blocks = [ex.unpack_cols(buf) for ex, buf in zip(exchanges, _all_to_all(sent))]
    for t, block in enumerate(blocks):
        assert block.shape == (B, rows, C)
        torch.testing.assert_close(block, whole.reshape(B, rows, -1)[..., t * C:(t + 1) * C], rtol=0, atol=0)
    back = _all_to_all([(ex.pack_cols(grad[..., t * C:(t + 1) * C]), *ex.splits(B, to_rows=True))
                        for t, ex in enumerate(exchanges)])
    for share, ex, buf in zip(shares, exchanges, back):
        want = torch.cat([grad.reshape(B, rows, heads, D)[:, r, share.heads] for r in share.rows(rows, causal=causal)],
                         dim=1)
        torch.testing.assert_close(ex.unpack_rows(buf), want, rtol=0, atol=0)


def _stacked(t, op):
    """An emulated reduction over ranks stacked on dim 0."""
    return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)


@pytest.mark.parametrize("heads,kv_heads,tp", [(8, 8, 16), (14, 2, 4)])
@pytest.mark.parametrize("kv_len", [30, 7, 1])
def test_decode_on_each_ranks_share_merged_equals_the_whole_decode(heads, kv_heads, tp, kv_len):
    """Each rank decodes with its share's heads over its slice of 30 cache
    rows (a replicated cross cache, as whisper-base's 1500 frames at
    ``model`` 16), its partial placed in its heads of a whole-head tensor
    (lse -inf elsewhere), merged over the ranks (``ops.merge_partials``),
    against the whole decode. At kv_len 7 and 1 the second slice of every
    group is empty."""
    gen = np.random.default_rng(kv_len)
    B, smax, D = 2, 30, 32
    q = _rand(gen, B, heads, D).to(torch.bfloat16)
    kc, vc = (_rand(gen, B, smax, kv_heads, D).to(torch.bfloat16) for _ in range(2))
    n = torch.tensor([kv_len], dtype=torch.int32)
    os_, lses = [], []
    for rank in range(tp):
        share = dist.row_split(_Mesh(tp, rank), heads, kv_heads)
        (rows,) = share.rows(smax)
        o_part, lse_part = da.decode_attention(q[:, share.heads], kc[:, rows, share.kv], vc[:, rows, share.kv],
                                               ops.local_kv_len(n, rows.start, rows.stop - rows.start),
                                               return_lse=True)
        o, lse = torch.zeros(B, heads, D), torch.full((B, heads), float("-inf"))
        o[:, share.heads], lse[:, share.heads] = o_part, lse_part
        os_.append(o)
        lses.append(lse)
    merged = ops.merge_partials(torch.stack(os_), torch.stack(lses), _stacked, q.dtype)[0]
    assert merged.dtype == q.dtype and not merged.isnan().any()
    whole = da.decode_attention(q, kc, vc, n)
    torch.testing.assert_close(merged.float(), whole.float(), rtol=TOL_BF16, atol=TOL_BF16)


# ---------------------------------------------------------------------------
# the row shares' inputs from the projections' column blocks, on emulated ranks
# ---------------------------------------------------------------------------


def _blocks(x, tp):
    """``x`` (B, S, n) as the ``tp`` column blocks a column-parallel product leaves on ``model``'s ranks."""
    return list(x.chunk(tp, dim=-1))


def _rope_tables(rows, D):
    from repro_torch.models import module as nn

    return nn.rope_tables(torch.arange(rows), D, 10_000.0)


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS)
@pytest.mark.parametrize("causal,rows", [(True, 32), (True, 23), (False, 23)])
def test_q_reaches_each_share_from_the_column_blocks(heads, kv_heads, tp, causal, rows):
    """``RowShareExchange.to_rows`` on emulated ranks: from each rank's
    column block of the whole q (B, S, H·D), each rank's share is the whole
    q's slice, its heads on its rows in ``rows`` order, bit for bit; the
    exchange back (``to_cols``, the way the share's output goes to ``wo``)
    gives each rank its block again; and RoPE on the share
    (``attention.rope_on_share``), at its rows' positions from the whole
    sequence's tables, is RoPE on the whole q, sliced, bit for bit (and on
    every row of a K, the whole q here, RoPE whole)."""
    from repro_torch.models import attention
    from repro_torch.models import module as nn

    gen = np.random.default_rng(rows + heads)
    B, D = 2, 16
    whole = _rand(gen, B, rows, heads, D).to(torch.bfloat16)
    blocks = _blocks(whole.flatten(2), tp)
    shares = [dist.row_split(_Mesh(tp, rank), heads, kv_heads) for rank in range(tp)]
    exchanges = [ops.RowShareExchange(share, rows, heads, D, tp, causal) for share in shares]
    got = [ex.unpack_rows(buf) for ex, buf in
           zip(exchanges, _all_to_all([(ex.pack_cols(b), *ex.splits(B, to_rows=True)) for ex, b in zip(exchanges, blocks)]))]
    cos, sin = _rope_tables(rows, D)
    rotated = nn.apply_rope(whole, None, tables=(cos, sin))
    for share, q in zip(shares, got):
        picked = share.rows(rows, causal=causal)
        assert torch.equal(q, torch.cat([whole[:, r, share.heads] for r in picked], dim=1))
        q_rot, k_rot = attention.rope_on_share(q, whole, picked, (cos, sin))
        assert torch.equal(q_rot, torch.cat([rotated[:, r, share.heads] for r in picked], dim=1))
        assert torch.equal(k_rot, rotated)
    back = [ex.unpack_cols(buf) for ex, buf in
            zip(exchanges, _all_to_all([(ex.pack_rows(q), *ex.splits(B)) for ex, q in zip(exchanges, got)]))]
    for b, want in zip(back, blocks):
        assert torch.equal(b, want)


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS + [(12, 2, 8), (20, 5, 8)])
@pytest.mark.parametrize("rows", [32, 23])
def test_kv_heads_reach_each_share_from_their_owners(heads, kv_heads, tp, rows):
    """``KvToShare`` on emulated ranks: from the column blocks of the whole
    K and V stacked (2B, S, KVH·D), each rank receives exactly the columns
    of the KV heads its share reads (``RowShare.kv_span``), every row, and
    RoPE on them is RoPE on the whole K, sliced, bit for bit; the backward
    sums each reader's gradient of those columns into their owner's block:
    the gradient of the gather, each owner's block of the readers' sum. (12,
    2, 8): groups inside one KV group, which read from ranks of the other
    group; (20, 5, 8): groups that span KV groups unevenly (a KV head a
    query head), whose KV columns lie on ranks outside the group too."""
    from repro_torch.models import module as nn

    gen = np.random.default_rng(rows * heads)
    B, D = 2, 16
    kv = _rand(gen, 2 * B, rows, kv_heads * D).to(torch.bfloat16)
    exchanges = [ops.KvToShare(heads, kv_heads, D, tp, rank) for rank in range(tp)]
    n = 2 * B * rows
    got = [ex.unpack(buf, 2 * B, rows) for ex, buf in
           zip(exchanges, _all_to_all([(ex.pack(b), *ex.splits(n)) for ex, b in zip(exchanges, _blocks(kv, tp))]))]
    tables = _rope_tables(rows, D)
    rotated = nn.apply_rope(kv.unflatten(-1, (kv_heads, D)), None, tables=tables)
    for rank, g in enumerate(got):
        lo, hi = dist.share_of(rank, heads, kv_heads, tp).kv_span()
        assert torch.equal(g, kv[..., lo * D:hi * D])
        assert torch.equal(nn.apply_rope(g.unflatten(-1, (hi - lo, D)), None, tables=tables), rotated[:, :, lo:hi])
    grads = [_rand(gen, *g.shape) for g in got]
    want = torch.zeros(2 * B, rows, kv_heads * D)
    for rank, g in enumerate(grads):
        lo, hi = dist.share_of(rank, heads, kv_heads, tp).kv_span()
        want[..., lo * D:hi * D] += g
    back = [ex.unpack_grad(buf, 2 * B, rows) for ex, buf in
            zip(exchanges, _all_to_all([(ex.pack_grad(g), *reversed(ex.splits(n))) for ex, g in zip(exchanges, grads)]))]
    torch.testing.assert_close(torch.cat(back, dim=-1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("heads,kv_heads,tp", SPLITS)
def test_prefill_cache_rows_from_the_shares(heads, kv_heads, tp):
    """Prefill's cache rows from the row shares, as
    ``ops.write_row_share_cache`` makes them where the cache lies in its
    rows over ``model``: each rank cuts its own column block out of the
    RoPE'd K/V columns it received (``ops.cache_exchange``), and one
    exchange (``to_rows`` of a share
    of every KV head over all tp ranks) gives rank t rows [t·S/tp,
    (t+1)·S/tp) of every KV head: the whole RoPE'd K's and V's rows, bit for
    bit."""
    from repro_torch.models import module as nn

    gen = np.random.default_rng(heads + tp)
    B, D, S = 2, 16, 32
    k, v = (_rand(gen, B, S, kv_heads * D).to(torch.bfloat16) for _ in range(2))
    tables = _rope_tables(S, D)
    kr = nn.apply_rope(k.unflatten(-1, (kv_heads, D)), None, tables=tables)
    sent = []
    for t in range(tp):
        share = dist.share_of(t, heads, kv_heads, tp)
        lo, hi = share.kv_span()
        received = [nn.apply_rope(k[..., lo * D:hi * D].unflatten(-1, (hi - lo, D)), None, tables=tables),
                    v[..., lo * D:hi * D].unflatten(-1, (hi - lo, D))]  # K/V as the share holds them
        own, ex = ops.cache_exchange(*received, share, kv_heads, tp, t)
        sent.append((ex, own))
    rows = [ex.unpack_rows(buf) for (ex, _), buf in
            zip(sent, _all_to_all([(ex.pack_cols(own), *ex.splits(2 * B, to_rows=True)) for ex, own in sent]))]
    n = S // tp
    for t, r in enumerate(rows):
        assert r.shape == (2 * B, n, kv_heads, D)
        assert torch.equal(r[:B], kr[:, t * n:(t + 1) * n])
        assert torch.equal(r[B:], v.unflatten(-1, (kv_heads, D))[:, t * n:(t + 1) * n])
