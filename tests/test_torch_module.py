"""PyTorch port vs the JAX reference: the module substrate and the loss.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: f32 inputs 1e-5 (same arithmetic, other summation order); bf16
inputs 2e-2 (the two frameworks round to bf16 at other places: one bf16 ulp
at the magnitudes used here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import losses as jlosses
from repro.models import module as jnn
from repro_torch.models import losses as tlosses
from repro_torch.models import module as tnn

DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _pair(a: np.ndarray, dtype: str):
    """The same f32 numpy array as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(t: torch.Tensor, j, tol: float):
    assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j.astype(jnp.float32)), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply(dtype, tol, bias):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((3, 5, 32), dtype=np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((32, 48), dtype=np.float32) / 32**0.5, dtype)
    pj, pt = {"w": wj}, {"w": wt}
    if bias:
        pj["b"], pt["b"] = _pair(rng.standard_normal(48, dtype=np.float32), dtype)
    kw_j = dict(compute_dtype=jnp.dtype(dtype))
    kw_t = dict(compute_dtype=getattr(torch, dtype))
    _close(tnn.dense_apply(pt, xt, **kw_t), jnn.dense_apply(pj, xj, **kw_j), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_embedding_apply(dtype, tol):
    rng = np.random.default_rng(1)
    tj, tt = _pair(rng.standard_normal((50, 16), dtype=np.float32), dtype)
    ids = rng.integers(0, 50, (4, 7), dtype=np.int32)
    got = tnn.embedding_apply({"table": tt}, torch.from_numpy(ids), compute_dtype=getattr(torch, dtype))
    want = jnn.embedding_apply({"table": tj}, jnp.asarray(ids), compute_dtype=jnp.dtype(dtype))
    _close(got, want, 0.0)  # a gather: exact


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rmsnorm_apply(dtype, tol):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 9, 64), dtype=np.float32) * 3.0, dtype)
    sj, st = _pair(1.0 + 0.1 * rng.standard_normal(64, dtype=np.float32), "float32")
    _close(tnn.rmsnorm_apply({"scale": st}, xt), jnn.rmsnorm_apply({"scale": sj}, xj), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_layernorm_apply(dtype, tol):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.standard_normal((2, 9, 64), dtype=np.float32) * 3.0 + 1.0, dtype)
    sj, st = _pair(1.0 + 0.1 * rng.standard_normal(64, dtype=np.float32), "float32")
    bj, bt = _pair(0.1 * rng.standard_normal(64, dtype=np.float32), "float32")
    _close(
        tnn.layernorm_apply({"scale": st, "bias": bt}, xt),
        jnn.layernorm_apply({"scale": sj, "bias": bj}, xj),
        tol,
    )


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(dtype, tol, theta):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((2, 11, 4, 16), dtype=np.float32), dtype)
    pos = np.arange(11, dtype=np.int32) + 5
    _close(
        tnn.apply_rope(xt, torch.from_numpy(pos), theta),
        jnn.apply_rope(xj, jnp.asarray(pos), theta),
        tol,
    )
    # the decode form: one position for the whole batch
    one = np.asarray([37], dtype=np.int32)
    _close(
        tnn.apply_rope(xt[:, :1], torch.from_numpy(one), theta),
        jnn.apply_rope(xj[:, :1], jnp.asarray(one), theta),
        tol,
    )


def test_rope_frequencies():
    np.testing.assert_allclose(
        tnn.rope_frequencies(64, 10_000.0).numpy(),
        np.asarray(jnn.rope_frequencies(64, 10_000.0)), rtol=1e-6,
    )


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("smoothing,masked", [(0.0, False), (0.1, False), (0.0, True), (0.1, True)])
def test_softmax_cross_entropy(dtype, tol, smoothing, masked):
    rng = np.random.default_rng(5)
    lj, lt = _pair(rng.standard_normal((2, 6, 40), dtype=np.float32) * 2.0, dtype)
    labels = rng.integers(0, 40, (2, 6), dtype=np.int32)
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32) if masked else None
    got, gm = tlosses.softmax_cross_entropy(
        lt, torch.from_numpy(labels), label_smoothing=smoothing,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    want, wm = jlosses.softmax_cross_entropy(
        lj, jnp.asarray(labels), label_smoothing=smoothing,
        mask=None if mask is None else jnp.asarray(mask),
    )
    # both upcast the logits to f32 first, so either input type holds 1e-5
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    assert set(gm) == set(wm)
    for key in wm:
        np.testing.assert_allclose(gm[key].item(), float(wm[key]), atol=1e-5, rtol=1e-5)


def test_trunc_normal_and_fan_in_init():
    gen = torch.Generator().manual_seed(0)
    w = tnn.fan_in_init(gen, (4, 256, 128), torch.float32, "cpu", scale=0.5)
    std = 0.5 / 256**0.5
    assert w.shape == (4, 256, 128) and w.dtype == torch.float32
    assert w.abs().max().item() <= 2 * std + 1e-7
    # a ±2σ truncated normal has standard deviation 0.880σ
    np.testing.assert_allclose(w.std().item(), 0.880 * std, rtol=2e-2)
    again = tnn.fan_in_init(torch.Generator().manual_seed(0), (4, 256, 128), torch.float32, "cpu", scale=0.5)
    assert torch.equal(w, again)


def test_scan_layers_and_counts():
    stacked = {"a": {"w": torch.arange(6.0).reshape(3, 2)}, "b": torch.ones(3, 4, dtype=torch.bfloat16)}
    seen = []
    out = tnn.scan_layers(lambda c, lp: (seen.append(lp["a"]["w"].tolist()), c + lp["a"]["w"].sum())[1], torch.zeros(()), stacked)
    assert seen == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    assert out.item() == 15.0
    assert tnn.param_count(stacked) == 18
    assert tnn.param_bytes(stacked) == 6 * 4 + 12 * 2
