"""PyTorch port vs the JAX reference: the rwkv6 slice (K5's plain version, the
chunked WKV, the model, its serving path).

Inputs from numpy seeds, weights converted from the reference's init, the same
arrays through both packages on the CPU. Tolerances:

* WKV6 in f32 (``ref.wkv6_reference``, ``wkv_chunked``, ``wkv_step``):
  atol = rtol = 5e-5, the reference's own wkv6 tolerance (tests/test_kernels.py).
* Logits: atol = rtol = 6e-2, the reference's serving tolerance
  (tests/test_decode_consistency.py); the two frameworks round to bf16 at other
  places. Loss: 3e-2, the reference's loss tolerance (tests/test_variants.py).
* Gradients: relative L2 error of each leaf <= 5e-2 (bf16 weights and
  activations; the port reads at most 0.011 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import rwkv6 as jrwkv
from repro.models.model_api import build_model as jax_build_model
from repro.runtime.serve_step import pad_cache as jax_pad_cache
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.models import rwkv6
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_paths
from repro_torch.runtime import serve_step
from repro_torch.sharding.plan import make_plan

ARCH = "rwkv6-1.6b"
TOL_WKV = dict(atol=5e-5, rtol=5e-5)
TOL_LOGITS = dict(atol=6e-2, rtol=6e-2)
TOL_GRAD_REL_L2 = 5e-2
B, S, EXTRA = 2, 16, 8  # S and S + EXTRA are multiples of the reduced chunk (8)

# (B, T, H, K, chunk, zero_state): the reference's WKV_CASES (tests/test_kernels.py)
WKV_CASES = [
    (1, 64, 2, 16, 16, True),
    (2, 128, 4, 32, 32, True),
    (1, 96, 2, 16, 32, False),
    (2, 64, 2, 8, 64, True),
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _wkv_inputs(B, T, H, K, zero_state, seed=0):
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((B, T, H, K), dtype=np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(g.standard_normal((B, T, H, K), dtype=np.float32) * 0.5 - 2.0)
    u = g.standard_normal((H, K), dtype=np.float32) * 0.2
    s0 = (np.zeros((B, H, K, K), np.float32) if zero_state
          else g.standard_normal((B, H, K, K), dtype=np.float32) * 0.3)
    return r, k, v, logw, u, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K5's plain version and the chunked WKV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_reference_matches_the_pallas_kernel(case):
    Bc, T, H, K, chunk, zero_state = case
    x = _wkv_inputs(Bc, T, H, K, zero_state)
    want_o, want_s = jops.wkv6(*_j(x), chunk=chunk, mode="interpret")
    got_o, got_s = ref.wkv6_reference(*_t(x))
    assert got_o.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL_WKV)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL_WKV)


def test_wkv6_strong_decay_is_stable():
    """The twin of the reference's test: logw = -3 a step (e^-192 a chunk)."""
    g = np.random.default_rng(3)
    r, k, v = (g.standard_normal((1, 64, 1, 8), dtype=np.float32) for _ in range(3))
    logw = np.full((1, 64, 1, 8), -3.0, np.float32)
    u, s0 = np.zeros((1, 8), np.float32), np.zeros((1, 1, 8, 8), np.float32)
    x = (r, k, v, logw, u, s0)
    want_o, want_s = jops.wkv6(*_j(x), chunk=64, mode="interpret")
    for got_o, got_s in (ref.wkv6_reference(*_t(x)), rwkv6.wkv_chunked(*_t(x), chunk=64)):
        assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
        np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL_WKV)
        np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL_WKV)


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_chunked_matches_reference(case):
    Bc, T, H, K, chunk, zero_state = case
    x = _wkv_inputs(Bc, T, H, K, zero_state, seed=1)
    want_o, want_s = jrwkv.wkv_chunked(*_j(x), chunk=chunk)
    got_o, got_s = rwkv6.wkv_chunked(*_t(x), chunk=chunk)
    np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL_WKV)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL_WKV)


def test_wkv_chunked_keeps_the_chunk_assertion():
    x = _t(_wkv_inputs(1, 20, 1, 8, True))
    with pytest.raises(AssertionError, match="divisible"):
        rwkv6.wkv_chunked(*x, chunk=8)


def test_wkv_step_matches_reference():
    g = np.random.default_rng(2)
    Bc, H, K = 3, 4, 16
    r, k, v = (g.standard_normal((Bc, H, K), dtype=np.float32) for _ in range(3))
    logw = -np.exp(g.standard_normal((Bc, H, K), dtype=np.float32) - 2.0)
    u = g.standard_normal((H, K), dtype=np.float32) * 0.2
    state = g.standard_normal((Bc, H, K, K), dtype=np.float32)
    x = (r, k, v, logw, u, state)
    want_o, want_s = jrwkv.wkv_step(*_j(x))
    got_o, got_s = rwkv6.wkv_step(*_t(x))
    np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL_WKV)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL_WKV)


def test_ops_wkv6_runs_the_plain_version_for_a_cpu_tensor():
    x = _t(_wkv_inputs(2, 40, 3, 16, False, seed=4))
    launches = rk.launch_count
    got = ops.wkv6(*x)
    want = ref.wkv6_reference(*x)
    assert rk.launch_count == launches  # nothing launched on the CPU
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # on the CPU the plain version is differentiable: no guard there
    x[0].requires_grad_(True)
    out, _ = ops.wkv6(*x)
    (grad,) = torch.autograd.grad(out.sum(), x[0])
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0


def test_wkv6_scan_checks_shapes():
    r, k, v, logw, u, s0 = _t(_wkv_inputs(1, 16, 2, 8, True))
    with pytest.raises(ValueError, match="u"):
        rk.wkv6_scan(r, k, v, logw, u[:1], s0)
    with pytest.raises(ValueError, match="takes r, k, logw"):
        rk.wkv6_scan(r, k[:, :8], v, logw, u, s0)


@pytest.mark.parametrize("dtype,width,offset,copied", [
    (torch.bfloat16, 64, 0, False),  # contiguous
    (torch.bfloat16, 65, 0, True),   # rows 130 bytes apart
    (torch.float32, 65, 0, True),    # 260 bytes apart
    (torch.float32, 68, 0, False),   # 272 bytes apart: a view the kernel reads in place
    (torch.bfloat16, 64, 1, True),   # contiguous, but starting 2 bytes past 16
])
def test_rows_off_16_bytes_are_copied_for_the_kernel(dtype, width, offset, copied):
    flat = torch.randn(offset + 2 * 96 * 3 * width + 8, generator=torch.Generator().manual_seed(0)).to(dtype)
    x = flat[offset: offset + 2 * 96 * 3 * width].view(2, 96, 3, width)[..., :64]
    got = rk.aligned_rows(x)
    assert (got is not x) == copied
    assert got.data_ptr() % 16 == 0
    assert all(st * got.element_size() % 16 == 0 for st in got.stride()[:3])
    assert got.stride(-1) == 1 and torch.equal(got, x)


@pytest.mark.parametrize("bh,n_sm,want", [(256, 132, 1), (96, 132, 2), (32, 132, 4), (1, 132, 4), (132, 132, 1)])
def test_value_columns_are_split_only_to_fill_the_card(bh, n_sm, want):
    assert rk.n_splits(bh, 1, n_sm) == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _setup(seed=0):
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = from_jax_params(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA), dtype=np.int32)
    return (jcfg, jmodel, jparams, jax_make_plan(jcfg, None)), (cfg, model, params, make_plan(cfg, None)), tokens


def test_port_init_has_the_reference_tree():
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    want = dict(tree_paths(jax.eval_shape(jmodel.init, jax.random.key(0))))
    model = build_model(get_config(ARCH).reduced())
    got = dict(tree_paths(model.init(torch.Generator().manual_seed(0), "cpu")))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path].shape) == spec.shape, path
        assert str(got[path].dtype).replace("torch.", "") == spec.dtype.name, path
    assert model.param_count() == jmodel.param_count()
    # the full config: 1.6 B parameters, counted on the meta device
    assert build_model(get_config(ARCH)).param_count() == jax_build_model(jax_get_config(ARCH)).param_count() \
        == 1_584_095_232


@torch.no_grad()
def test_forward_logits_match_reference():
    (jcfg, _, jparams, jplan), (cfg, _, params, plan), tokens = _setup()
    want = jrwkv.forward(jcfg, jparams, jnp.asarray(tokens), jplan)
    got = rwkv6.forward(cfg, params, torch.from_numpy(tokens), plan)
    assert got.shape == (B, S + EXTRA, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_LOGITS)


@torch.no_grad()
def test_loss_matches_reference():
    (_, jmodel, jparams, jplan), (_, model, params, plan), tokens = _setup()
    jbatch = {"tokens": jnp.asarray(tokens[:, :-EXTRA]), "labels": jnp.asarray(tokens[:, 1:1 - EXTRA])}
    batch = {"tokens": torch.from_numpy(tokens[:, :-EXTRA]), "labels": torch.from_numpy(tokens[:, 1:1 - EXTRA])}
    want, wm = jmodel.loss(jparams, jbatch, jplan)
    got, gm = model.loss(params, batch, plan)
    np.testing.assert_allclose(got.item(), float(want), atol=3e-2, rtol=3e-2)
    assert set(gm) == set(wm)


def test_loss_and_grads_match_jax_grad():
    """Autograd through the port's ``wkv_chunked`` (the CPU path) against
    ``jax.grad`` through the reference's."""
    (_, jmodel, jparams, jplan), (_, model, params, plan), tokens = _setup(seed=2)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-EXTRA]), "labels": jnp.asarray(tokens[:, 1:1 - EXTRA])}
    batch = {"tokens": torch.from_numpy(tokens[:, :-EXTRA]), "labels": torch.from_numpy(tokens[:, 1:1 - EXTRA])}
    (want, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jbatch, jplan)
    names, leaves = zip(*tree_paths(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    got, _ = model.loss(params, batch, plan)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), atol=3e-2, rtol=3e-2)
    jg = dict(tree_paths(jax.device_get(jgrads)))
    errs = {}
    for name, grad in zip(names, grads):
        w = np.asarray(jg[name], dtype=np.float32)
        g = np.zeros_like(w) if grad is None else _np(grad)
        errs[name] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    bad = {n: e for n, e in errs.items() if e > TOL_GRAD_REL_L2 and np.linalg.norm(jg[n]) > 0}
    assert not bad, bad
    # decay_lora/b starts at zero; its gradient is what moves the decay, and it flows
    assert np.linalg.norm(jg[("layers", "time_mix", "decay_lora", "b")]) > 0


@torch.no_grad()
def test_prefill_and_decode_match_reference():
    (_, jmodel, jparams, jplan), (cfg, model, params, plan), tokens = _setup()
    jlast, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])}, jplan)
    last, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])}, plan)
    assert last.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL_LOGITS)
    for name in ("wkv", "tm_x", "cm_x"):
        assert cache[name].shape == jcache[name].shape
        assert str(cache[name].dtype).replace("torch.", "") == jcache[name].dtype.name
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL_LOGITS)

    # pad_cache leaves the recurrent state alone, in both packages
    jcache = jax_pad_cache(jcache, EXTRA)
    padded = serve_step.pad_cache(cache, EXTRA)
    assert all(padded[n] is cache[n] for n in cache)
    assert {n: tuple(c.shape) for n, c in padded.items()} == {n: c.shape for n, c in jcache.items()}
    for i in range(EXTRA):
        jlogits, jcache = jmodel.decode(jparams, {"token": jnp.asarray(tokens[:, S + i])}, jcache, S + i, jplan)
        logits, padded = model.decode(params, {"token": torch.from_numpy(tokens[:, S + i])}, padded, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"decode step {i}", **TOL_LOGITS)
    np.testing.assert_allclose(_np(padded["wkv"]), _np(jcache["wkv"]), **TOL_LOGITS)


@torch.no_grad()
def test_incremental_decode_matches_forward():
    """The twin of tests/test_decode_consistency.py for rwkv: the port against itself."""
    _, (cfg, model, params, plan), tokens = _setup()
    tokens = torch.from_numpy(tokens)
    ref_logits = rwkv6.forward(cfg, params, tokens, plan)
    last, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    np.testing.assert_allclose(_np(last), _np(ref_logits[:, S - 1]), **TOL_LOGITS)
    cache = serve_step.pad_cache(cache, EXTRA)
    for i in range(EXTRA):
        logits, cache = model.decode(params, {"token": tokens[:, S + i]}, cache, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(ref_logits[:, S + i]), err_msg=f"step {i}", **TOL_LOGITS)


@torch.no_grad()
def test_decode_updates_the_state_in_place():
    _, (cfg, model, params, plan), tokens = _setup()
    tokens = torch.from_numpy(tokens)
    _, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    kept = {n: c.clone() for n, c in cache.items()}
    _, new = model.decode(params, {"token": tokens[:, S]}, cache, S, plan)
    assert all(new[n].data_ptr() == cache[n].data_ptr() for n in cache)
    assert all(not torch.equal(cache[n], kept[n]) for n in cache)


def test_cache_spec_matches_reference():
    for cfg_fn, jcfg_fn in ((lambda: get_config(ARCH).reduced(), lambda: jax_get_config(ARCH).reduced()),
                            (lambda: get_config(ARCH), lambda: jax_get_config(ARCH))):
        got = build_model(cfg_fn()).cache_spec(B, S)
        want = jax_build_model(jcfg_fn()).cache_spec(B, S)
        assert list(got) == list(want)
        for name, (shape, dtype) in got.items():
            assert shape == want[name].shape and str(dtype).replace("torch.", "") == want[name].dtype.name
    spec = build_model(get_config(ARCH)).cache_spec(8, 2080)
    assert spec == {"wkv": ((24, 8, 32, 64, 64), torch.float32),
                    "tm_x": ((24, 8, 2048), torch.bfloat16), "cm_x": ((24, 8, 2048), torch.bfloat16)}


@torch.no_grad()
def test_greedy_generate_runs_the_rwkv_family():
    _, (cfg, model, params, plan), tokens = _setup()
    prompt = torch.from_numpy(tokens[:, :S])
    out = serve_step.greedy_generate(model, params, prompt, 5, plan)
    assert out.shape == (B, 5) and out.dtype == torch.int32
    assert (out >= 0).all() and (out < cfg.vocab).all()
    last, _ = serve_step.build_prefill(model, plan)(params, {"tokens": prompt})
    assert torch.equal(torch.argmax(last, -1).to(torch.int32), out[:, 0])
