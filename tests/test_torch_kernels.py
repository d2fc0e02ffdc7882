"""PyTorch port vs the JAX reference: the kernels' plain versions, the layout
folds and the blocked attention path.

On a CPU tensor every kernel wrapper of the port runs its plain version
(``repro_torch.kernels.ref``), so what is held here against the JAX package
is that plain version, which the CUDA kernels are in turn held against on the
card by ``chip_smoke.py``. The JAX side runs its Pallas kernels in interpret
mode, as the JAX package's own tests do, and its pure-jnp oracles.

Tolerances are the reference's own (tests/test_kernels.py): f32 2e-5, bf16
2e-2, lse 1e-4.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# benchmarks/ lies at the repo root, which is on sys.path only under `python -m pytest`
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.kernel_bench import CALIBRATION_SHAPES  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype: str):
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

_cal = CALIBRATION_SHAPES["flash_attention"]
FLASH_CASES = [
    # (B, Sq, Skv, H, KVH, D, causal, dtype, bq, bk): the table of tests/test_kernels.py
    (1, 64, 64, 4, 4, 32, True, "float32", 16, 16),   # MHA
    (2, 128, 128, 8, 2, 64, True, "float32", 32, 64),  # GQA g=4
    (2, 128, 128, 8, 1, 32, True, "float32", 64, 32),  # MQA
    (1, 96, 96, 4, 4, 16, True, "float32", 32, 32),    # non-pow2 seq
    (1, 64, 64, 4, 2, 32, False, "float32", 16, 32),   # non-causal
    (2, 64, 64, 8, 4, 64, True, "bfloat16", 32, 32),   # bf16 io
    (1, 64, 64, 8, 2, 160, True, "float32", 32, 32),   # head_dim 160 (stablelm-12b), G=4
    (1, 48, 48, 4, 1, 160, True, "bfloat16", 16, 16),  # head_dim 160, MQA, bf16
    (1, 64, 64, 4, 4, 112, True, "float32", 32, 32),   # head_dim 112 (zamba2-7b), G=1
    (1, 48, 40, 8, 2, 112, False, "bfloat16", 16, 8),  # head_dim 112, G=4, non-causal, Sq != Skv, bf16
    # the calibration shape of benchmarks/kernel_bench.py
    (_cal["B"], _cal["S"], _cal["S"], _cal["H"], _cal["KVH"], _cal["D"], True, "float32",
     _cal["block_q"], _cal["block_k"]),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_matches_jax_kernel_and_oracle(case):
    B, Sq, Skv, H, KVH, D, causal, dtype, bq, bk = case
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng, (B, Sq, H, D), dtype)
    kj, kt = _pair(rng, (B, Skv, KVH, D), dtype)
    vj, vt = _pair(rng, (B, Skv, KVH, D), dtype)
    o_kernel = jops.flash_attention(qj, kj, vj, causal=causal, block_q=bq, block_k=bk, mode="interpret")
    o_oracle = jref.mha_reference(qj, kj, vj, causal=causal)
    got_ops = tops.flash_attention(qt, kt, vt, causal=causal)  # CPU tensor: the plain version
    got_ref = tref.mha_reference(qt, kt, vt, causal=causal)
    assert got_ops.shape == (B, Sq, H, D) and got_ops.dtype == qt.dtype
    for got in (got_ops, got_ref):
        np.testing.assert_allclose(_np(got), _np(o_kernel), **_tol(dtype))
        np.testing.assert_allclose(_np(got), _np(o_oracle), **_tol(dtype))


@pytest.mark.parametrize("q_offset,causal", [(0, True), (32, True), (7, True), (0, False)])
def test_flash_fwd_lse_and_q_offset(q_offset, causal):
    """(o, lse) of the folded entry point, with the q_offset that ops never forwards."""
    B, Sq, Skv, H, KVH, D = 1, 32, 64, 4, 2, 16
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (B, Sq, H, D), "float32")
    kj, kt = _pair(rng, (B, Skv, KVH, D), "float32")
    vj, vt = _pair(rng, (B, Skv, KVH, D), "float32")
    scale = D**-0.5
    o_j, lse_j = jfa.flash_attention_fwd(
        jops._fold(qj, KVH), jops._kv_fold(kj), jops._kv_fold(vj), causal=causal,
        scale=scale, block_q=8, block_k=8, q_offset=q_offset, interpret=True,
    )
    o_t, lse_t = tfa.flash_attention_fwd(
        tops._fold(qt, KVH), tops._kv_fold(kt), tops._kv_fold(vt), causal=causal,
        scale=scale, q_offset=q_offset,
    )
    assert o_t.shape == (B, KVH, Sq, H // KVH, D)
    assert lse_t.shape == (B, KVH, Sq, H // KVH) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=1e-4, rtol=1e-4)
    want = jref.mha_reference(qj, kj, vj, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(tops._unfold(o_t)), _np(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(tref.mha_reference(qt, kt, vt, causal=causal, q_offset=q_offset)), _np(want),
        atol=2e-5, rtol=2e-5,
    )


def test_flash_lse_is_true_logsumexp():
    B, S, H, KVH, D = 1, 32, 4, 2, 16
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (B, S, H, D), "float32")
    _, k = _pair(rng, (B, S, KVH, D), "float32")
    _, v = _pair(rng, (B, S, KVH, D), "float32")
    _, lse = tfa.flash_attention_fwd(
        tops._fold(q, KVH), tops._kv_fold(k), tops._kv_fold(v), causal=True, scale=D**-0.5
    )
    scores = torch.einsum("bqhgd,bkhd->bhqgk", q.reshape(B, S, KVH, H // KVH, D) * D**-0.5, k)
    mask = torch.arange(S)[:, None] >= torch.arange(S)[None, :]
    scores = scores.masked_fill(~mask[None, None, :, None, :], float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, dim=-1).numpy(), atol=1e-4, rtol=1e-4)


def test_fold_round_trips():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 6, 4), "float32")
    np.testing.assert_array_equal(_np(tops._fold(xt, 2)), _np(jops._fold(xj, 2)))
    np.testing.assert_array_equal(_np(tops._kv_fold(xt)), _np(jops._kv_fold(xj)))
    assert tops._fold(xt, 2).shape == (2, 2, 5, 3, 4)
    assert torch.equal(tops._unfold(tops._fold(xt, 2)), xt)
    assert torch.equal(tops._kv_fold(tops._kv_fold(xt)), xt)
    # the folds are views: the CUDA kernel reads them through strides, no copy
    assert tops._fold(xt, 2).data_ptr() == xt.data_ptr()
    assert tops._kv_fold(xt).data_ptr() == xt.data_ptr()


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

_dcal = CALIBRATION_SHAPES["decode_attention"]
DECODE_CASES = [
    # (B, Smax, H, KVH, D, kv_len, bk): the table of tests/test_kernels.py
    (2, 128, 8, 2, 32, 128, 32),   # kv_len at Smax
    (2, 128, 8, 2, 32, 77, 32),    # partial cache, mid-block
    (1, 256, 4, 4, 64, 1, 64),     # single valid entry
    (3, 96, 6, 1, 16, 50, 32),     # MQA, odd sizes
    (2, 96, 8, 2, 160, 77, 32),    # head_dim 160 (stablelm-12b), G=4
    (2, 96, 4, 4, 112, 77, 32),    # head_dim 112 (zamba2-7b), G=1
    (_dcal["B"], _dcal["Smax"], _dcal["H"], _dcal["KVH"], _dcal["D"], _dcal["kv_len"], _dcal["block_k"]),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_kernel_and_oracle(case, dtype):
    B, Smax, H, KVH, D, kv_len, bk = case
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng, (B, H, D), dtype)
    kj, kt = _pair(rng, (B, Smax, KVH, D), dtype)
    vj, vt = _pair(rng, (B, Smax, KVH, D), dtype)
    o_kernel = jops.decode_attention(qj, kj, vj, kv_len=kv_len, block_k=bk, mode="interpret")
    o_oracle = jref.decode_attention_reference(qj, kj, vj, kv_len=kv_len)
    got = tops.decode_attention(qt, kt, vt, kv_len=kv_len)
    assert got.shape == (B, H, D) and got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(o_kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(o_oracle), **_tol(dtype))
    # the 4-d form of the model path, and kv_len as a 1-element int32 tensor
    got4 = tops.decode_attention(
        qt[:, None], kt, vt, kv_len=torch.tensor([kv_len], dtype=torch.int32)
    )
    assert got4.shape == (B, 1, H, D)
    assert torch.equal(got4[:, 0], got)


def test_decode_kv_len_tensor_changes_between_calls():
    """Twin of test_decode_traced_kv_len: one int32 tensor, refilled, no new objects."""
    B, Smax, H, KVH, D = 1, 64, 4, 2, 16
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (B, H, D), "float32")
    kj, kt = _pair(rng, (B, Smax, KVH, D), "float32")
    vj, vt = _pair(rng, (B, Smax, KVH, D), "float32")
    kv_len = torch.zeros(1, dtype=torch.int32)
    for n in (1, 13, 64):
        kv_len.fill_(n)
        np.testing.assert_allclose(
            _np(tda.decode_attention(qt, kt, vt, kv_len)),
            _np(jref.decode_attention_reference(qj, kj, vj, kv_len=n)),
            atol=2e-5, rtol=2e-5,
        )


def test_wrappers_raise_on_what_they_do_not_take():
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    k = torch.zeros(1, 4, 2, 8)
    (dq,) = torch.autograd.grad(tops.flash_attention(q, k, k).sum(), q)  # differentiable now
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    with pytest.raises(NotImplementedError):
        tops.decode_attention(torch.zeros(1, 2, 8, requires_grad=True), k, k, kv_len=1)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(k, k, k, causal=True, scale=1.0)  # q not folded
    with pytest.raises(TypeError):
        tda.decode_attention(torch.zeros(1, 2, 8, dtype=torch.bfloat16), k, k, 1)
    assert tfa.launch_count == 0 and tda.launch_count == 0  # the CPU never counts a launch


def test_decode_split_heuristic_depends_on_shapes_only():
    # the serving shape on a 132-SM card: 64 (batch, kv head) clusters of 2
    # blocks, 128 blocks for 132 places
    assert tda.n_splits(8, 8, 4, 2080, 132) == 2
    assert tda.n_splits(128, 8, 4, 32768, 132) == 1   # enough blocks already
    assert tda.n_splits(1, 1, 1, 100, 132) == 1       # never below MIN_ROWS_PER_SPLIT rows
    assert tda.n_splits(1, 1, 1, 300, 132) == 2       # a power of two up to that
    assert tda.n_splits(1, 2, 8, 4096, 132) == 16     # never above the largest cluster
    assert tda.n_splits(1, 8, 4, 2080, 132) == 8      # batch 1 of granite-3-2b: splits of 260 rows
    assert tda.n_splits(2, 8, 4, 2080, 132) == 8      # 16 sweeps, 128 blocks
    assert tda.n_splits(1, 4, 16, 4096, 132) == 16    # 16 query heads: two blocks a kv head


# ---------------------------------------------------------------------------
# the blocked path of models/attention.py
# ---------------------------------------------------------------------------

XLA_CASES = [
    # (B, Sq, Skv, H, KVH, D, causal, block_k, q_offset, kv_len, dtype)
    (2, 24, 24, 4, 2, 16, True, 8, 0, None, "float32"),
    (2, 24, 24, 4, 2, 16, True, 16, 0, None, "float32"),     # KV padding: 24 = 16 + 8
    (1, 5, 40, 4, 1, 16, True, 16, 35, None, "float32"),     # q_offset + padding
    (2, 1, 32, 8, 2, 16, True, 8, 20, 21, "float32"),        # decode form: kv_len
    (2, 16, 16, 4, 4, 32, False, 1024, 0, None, "float32"),  # non-causal, one block
    (2, 24, 24, 4, 2, 16, True, 16, 0, None, "bfloat16"),
    (2, 1, 32, 8, 2, 16, True, 8, 20, 21, "bfloat16"),
]


@pytest.mark.parametrize("case", XLA_CASES)
def test_xla_flash_attention_matches_reference(case):
    B, Sq, Skv, H, KVH, D, causal, block_k, q_offset, kv_len, dtype = case
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (B, Sq, H, D), dtype)
    kj, kt = _pair(rng, (B, Skv, KVH, D), dtype)
    vj, vt = _pair(rng, (B, Skv, KVH, D), dtype)
    kw = dict(causal=causal, block_k=block_k, q_offset=q_offset)
    want = jattn.xla_flash_attention(qj, kj, vj, kv_len=None if kv_len is None else jnp.int32(kv_len), **kw)
    got = tattn.xla_flash_attention(qt, kt, vt, kv_len=kv_len, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # on the CPU the dispatching entry point is the same path
    assert torch.equal(tattn.flash_attention(qt, kt, vt, kv_len=kv_len, **kw), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 19, 48])
def test_model_decode_attention_matches_reference(dtype, kv_len):
    B, Smax, H, KVH, D = 2, 48, 8, 2, 16
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (B, 1, H, D), dtype)
    kj, kt = _pair(rng, (B, Smax, KVH, D), dtype)
    vj, vt = _pair(rng, (B, Smax, KVH, D), dtype)
    want = jattn.decode_attention(qj, kj, vj, kv_len=kv_len)
    got = tattn.decode_attention(qt, kt, vt, kv_len=torch.tensor([kv_len], dtype=torch.int32))
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_dispatch_depends_on_arguments_only():
    """No process-wide switch: on a CPU tensor the dispatching entry points
    are their non-kernel paths, bit for bit, and launch no kernel."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa

    assert not hasattr(tattn, "kernels_disabled")
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (2, 1, 8, 16), "bfloat16")
    _, kc = _pair(rng, (2, 40, 2, 16), "bfloat16")
    _, vc = _pair(rng, (2, 40, 2, 16), "bfloat16")
    before = (tfa.launch_count, tda.launch_count)
    got = tattn.decode_attention(q, kc, vc, kv_len=17)
    assert torch.equal(got, tattn.torch_decode_attention(q, kc, vc, kv_len=17))
    assert (tfa.launch_count, tda.launch_count) == before
