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
