"""PyTorch port vs the JAX reference: AdamW (``repro_torch.optim.adamw``).

Same parameters (the granite-3-2b reduced tree, converted), the same
gradients (numpy, in each leaf's type) into both ``apply_updates``: m, v and
the f32 parameters to 1e-6, bf16 parameters equal or one bf16 ulp apart (the
two frameworks may round the f32 update differently by one f32 ulp, which can
flip the final rounding). The global norm is a sum of about 10^6 squares in
f32 that the two frameworks take in different orders: it, and what active
clipping scales by it, are held to 1e-5. Plus the twins of
tests/test_optimizer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.model_api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.convert import from_jax_params
from repro_torch.models.module import tree_map, tree_paths
from repro_torch.optim import adamw as tadamw

F32 = dict(rtol=1e-6, atol=1e-9)
NORM = dict(rtol=1e-5, atol=1e-9)  # a reduction in another order, and what it scales


def _flat(tree):
    return {"/".join(p): x for p, x in tree_paths(tree)}


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(e.key) for e in path): x for path, x in flat}


def _assert_bf16_within_one_ulp(got: torch.Tensor, want: np.ndarray, name: str):
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = torch.from_numpy(np.asarray(want, dtype=np.float32)).to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32)
    assert np.abs(a - b).max() <= 1, name


@pytest.fixture(scope="module")
def granite_tree():
    params = jax_build_model(jax_get_config("granite-3-2b").reduced()).init(jax.random.key(0))
    return jax.device_get(params)


def _grads(host_params, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in _jflat(host_params).items():
        out[path] = (rng.standard_normal(leaf.shape, dtype=np.float32) * 0.05).astype(leaf.dtype)
    return out


def _unflat(flat, like_tree, prefix=""):
    return {
        k: _unflat(flat, v, f"{prefix}{k}/") if isinstance(v, dict) else flat[f"{prefix}{k}"]
        for k, v in like_tree.items()
    }


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_apply_updates_matches_reference(granite_tree, clip_norm):
    cfg_j = jadamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    cfg_t = tadamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    pj = jax.tree_util.tree_map(jnp.asarray, granite_tree)
    sj = jadamw.init_state(pj, cfg_j)
    pt = from_jax_params(granite_tree, "cpu")
    st = tadamw.init_state(pt, cfg_t)
    tol = F32 if clip_norm > 1e6 else NORM  # 1e9: clipping never bites, the norm scales nothing
    for step in range(3):
        g = _grads(granite_tree, step)
        gj = jax.tree_util.tree_map(jnp.asarray, _unflat(g, granite_tree))
        gt = from_jax_params(_unflat(g, granite_tree), "cpu")
        pj, sj, mj = jadamw.apply_updates(pj, gj, sj, cfg_j)
        pt, st, mt = tadamw.apply_updates(pt, gt, st, cfg_t)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), **NORM)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
        assert int(st.step) == int(sj.step) == step + 1 and st.step.dtype == torch.int32
        for name, want in _jflat(pj).items():
            got = _flat(pt)[name]
            if got.dtype == torch.bfloat16:
                _assert_bf16_within_one_ulp(got, want, name)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)
        for tree_t, tree_j in ((st.m, sj.m), (st.v, sj.v)):
            for name, want in _jflat(tree_j).items():
                got = _flat(tree_t)[name]
                assert got.dtype == torch.float32, name
                np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 250, 399, 400, 450])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=100, total_steps=400)
    want = float(jadamw.cosine_schedule(jadamw.AdamWConfig(**kw), jnp.int32(step)))
    got = tadamw.cosine_schedule(tadamw.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_clip_by_global_norm_matches_reference(granite_tree):
    g = _unflat(_grads(granite_tree, 7), granite_tree)
    gj = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.float32), g)
    gt = {k: v for k, v in from_jax_params(g, "cpu").items()}
    gt = tree_map(lambda x: x.float(), gt)
    cj, nj = jadamw.clip_by_global_norm(gj, 0.5)
    ct, nt = tadamw.clip_by_global_norm(gt, 0.5)
    np.testing.assert_allclose(float(nt), float(nj), **NORM)
    np.testing.assert_allclose(float(tadamw.global_norm(ct)), 0.5, rtol=1e-5)
    for name, want in _jflat(cj).items():
        np.testing.assert_allclose(_flat(ct)[name].numpy(), np.asarray(want), err_msg=name, **NORM)


def test_decay_mask_matches_reference_leaf_by_leaf(granite_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(granite_tree)
    assert len(flat) > 5
    for path, _ in flat:
        names = tuple(str(e.key) for e in path)
        assert tadamw._decay_mask(names) == jadamw._decay_mask(path), names
    for name in ("scale", "bias", "bq", "b", "dt_bias", "w", "table", "w_lm"):
        assert tadamw._decay_mask(("x", name)) == jadamw._decay_mask((jax.tree_util.DictKey(name),))


# ---------------------------------------------------------------------------
# twins of tests/test_optimizer.py
# ---------------------------------------------------------------------------


def test_adamw_descends_quadratic():
    cfg = tadamw.AdamWConfig(lr_peak=0.1, lr_min=0.01, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = tadamw.init_state(params, cfg)
    l0 = float(params["w"].square().sum())
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(w.square().sum(), w)
        params, state, _ = tadamw.apply_updates({"w": w}, {"w": g}, state, cfg)
    assert float(params["w"].detach().square().sum()) < 1e-2 * l0


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    clipped, norm = tadamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(tadamw.global_norm(clipped)), 1.0, rtol=1e-5)


def test_decay_mask_skips_norm_params():
    cfg = tadamw.AdamWConfig(lr_peak=0.1, lr_min=0.1, warmup_steps=0, total_steps=2,
                             weight_decay=1.0, clip_norm=1e9)
    params = {"w": torch.ones(3), "scale": torch.ones(3)}
    grads = {"w": torch.zeros(3), "scale": torch.zeros(3)}
    state = tadamw.init_state(params, cfg)
    new, _, _ = tadamw.apply_updates(params, grads, state, cfg)
    assert float((new["scale"] - 1.0).abs().max()) == 0.0, "norm param decayed"
    assert float((new["w"] - 1.0).abs().max()) > 0.0, "kernel not decayed"


def test_update_runs_in_slices_with_the_same_numbers(monkeypatch):
    """Slicing a leaf for the update changes no number."""
    cfg = tadamw.AdamWConfig(lr_peak=1e-2, warmup_steps=0, total_steps=4)
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.standard_normal((10, 37), dtype=np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((10, 37), dtype=np.float32)).to(torch.bfloat16)

    def one_step():
        params = {"w": p0.clone()}
        out, st, _ = tadamw.apply_updates(params, {"w": g}, tadamw.init_state(params, cfg), cfg)
        return out["w"], st.m["w"], st.v["w"]

    whole = one_step()
    monkeypatch.setattr(tadamw, "CHUNK", 16)
    sliced = one_step()
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
