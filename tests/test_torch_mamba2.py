"""PyTorch port vs the JAX reference: the mamba2 hybrid (``models/mamba2.py``).

The chunked SSD scan against the reference and against its own one-step form
taken token by token; the causal conv with and without a tail; a mamba2
block over a sequence and step by step; then zamba2-7b reduced (2 mamba2
layers, d 64, the shared attention block before each group of 2) and
``zamba2-7b-d112``, reduced but with the shared block's head_dim of 112 and
3 layers in two groups (2 and 1), so that the shared block's K/V cache holds
two applications. For both: loss, every gradient, prefill and 8 decode
steps, weights converted from the reference's init, inputs made with numpy
from a seed.

The reference runs compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so that it rounds to bf16 where its
program says so, as PyTorch's eager ops do. Tolerances are the reference
tests': f32 2e-5, bf16 2e-2, logits 6e-2, loss 3e-2; each gradient leaf to
a relative L2 error of 2e-2, bf16's. The SSM state is f32, but where it sums
inputs that were rounded to bf16 at other places (the step's conv sums in
f32 and rounds once, the sequence's conv rounds after each tap; the shared
attention block's output) it is held as the gradients are, to a relative
L2 error of 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mamba2 as jm2
from repro.models.model_api import build_model as jax_build_model
from repro.runtime.serve_step import pad_cache as jax_pad_cache
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import mamba2
from repro_torch.models.model_api import build_model
from repro_torch.models.module import layer_params, tree_map, tree_paths
from repro_torch.runtime import serve_step
from repro_torch.sharding.plan import make_plan

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
LOGITS = dict(atol=6e-2, rtol=6e-2)
LOSS = dict(atol=3e-2, rtol=3e-2)
TOL_GRAD = 2e-2  # relative L2 error of each gradient leaf
#: zamba2-7b reduced with its shared block's head_dim of 112 kept (the reduced
#: config has 16): 2 heads over 2 KV heads (G = 1, as zamba2's 32/32), 3 layers
D112 = {"zamba2-7b-d112": ("zamba2-7b", dict(n_heads=2, n_kv_heads=2, head_dim=112, n_layers=3))}
ARCHS = ["zamba2-7b", "zamba2-7b-d112"]
B, S, EXTRA = 2, 16, 8


def reduced_configs(arch):
    name, overrides = D112.get(arch, (arch, {}))
    return jax_get_config(name).reduced(**overrides), get_config(name).reduced(**overrides)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_rel_l2(got, want, tol, name=""):
    """||got - want|| / ||want|| <= tol, in float64."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert rel <= tol, f"{name}: relative L2 error {rel} > {tol}"


def strict(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off (see above)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _jt(rng, shape, dtype="float32", scale=1.0, offset=0.0):
    a = (rng.standard_normal(shape, dtype=np.float32) * scale + offset).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the SSD core, the conv, one block
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, Bn=2, T=32, H=3, P=4, N=5):
    x = _jt(rng, (Bn, T, H, P))
    dt_np = np.abs(np.asarray(x[0][..., 0])) * 0.5 + 0.05
    dt = (jnp.asarray(dt_np), torch.from_numpy(dt_np.copy()))
    A = _jt(rng, (H,), scale=0.0, offset=-1.0)
    A = (A[0] * jnp.arange(1, H + 1, dtype=jnp.float32), A[1] * torch.arange(1, H + 1, dtype=torch.float32))
    Bm, Cm = _jt(rng, (Bn, T, N)), _jt(rng, (Bn, T, N))
    s0 = _jt(rng, (Bn, H, P, N), scale=0.5)
    return [t[0] for t in (x, dt, A, Bm, Cm, s0)], [t[1] for t in (x, dt, A, Bm, Cm, s0)]


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference_and_its_steps(chunk):
    j, t = _ssd_inputs(np.random.default_rng(0))
    yj, sj = jm2.ssd_chunked(*j, chunk=chunk)
    yt, st = mamba2.ssd_chunked(*t, chunk=chunk)
    assert yt.dtype == st.dtype == torch.float32 and yt.shape == (2, 32, 3, 4)
    np.testing.assert_allclose(_np(yt), _np(yj), **F32)
    np.testing.assert_allclose(_np(st), _np(sj), **F32)
    # the chunked form is the recurrence: ssd_step token by token, from the same state
    x, dt, A, Bm, Cm, state = t
    ys = []
    for i in range(x.shape[1]):
        y, state = mamba2.ssd_step(x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i], state)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(yt), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(state), _np(st), atol=1e-4, rtol=1e-4)
    with pytest.raises(AssertionError):
        mamba2.ssd_chunked(*t, chunk=12)  # T % chunk != 0 stays an error, as in the reference


def test_ssd_decay_is_masked_before_the_exp():
    """Strong decay: above the diagonal the pairwise differences are large and
    positive; masked first they never reach the exp, so nothing overflows."""
    rng = np.random.default_rng(1)
    j, t = _ssd_inputs(rng, T=16)
    t[1] = t[1] * 400.0
    j[1] = j[1] * 400.0
    yt, st = mamba2.ssd_chunked(*t, chunk=16)
    yj, sj = jm2.ssd_chunked(*j, chunk=16)
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(_np(yt), _np(yj), **F32)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_seq(with_tail):
    rng = np.random.default_rng(2)
    wj, wt = _jt(rng, (4, 12), "bfloat16", scale=0.3)
    bj, bt = _jt(rng, (12,), "bfloat16", scale=0.1)
    xj, xt = _jt(rng, (2, 9, 12), "bfloat16")
    tj, tt = _jt(rng, (2, 3, 12), "bfloat16") if with_tail else (None, None)
    yj, nj = jm2._causal_conv_seq(wj, bj, xj, tj)
    yt, nt = mamba2._causal_conv_seq(wt, bt, xt, tt)
    assert yt.dtype == torch.bfloat16 and nt.shape == (2, 3, 12)
    np.testing.assert_allclose(_np(yt), _np(yj), **BF16)
    np.testing.assert_array_equal(_np(nt), _np(nj))  # the tail is the last K - 1 inputs
    np.testing.assert_array_equal(_np(nt), _np(xt[:, -3:]))


def test_mamba_seq_and_step_match_reference():
    """One block over a sequence (from a tail, as a chunked continuation would
    run) and token by token, each against the reference's, and against each
    other."""
    jcfg, cfg = reduced_configs("zamba2-7b")
    jp = jax.device_get(jm2.init_mamba_block(jcfg, jax.random.key(3)))
    jp = {**jp, "dt_bias": jp["dt_bias"] + 0.5, "D": jp["D"] * 0.7}  # not the init's 0 and 1
    p = from_jax_params(jp, "cpu")
    d_inner, H, P, N = mamba2._inner(cfg)
    conv_ch = d_inner + 2 * N
    rng = np.random.default_rng(4)
    xj, xt = _jt(rng, (B, S, cfg.d_model), "bfloat16")
    sj, st = _jt(rng, (B, H, P, N), scale=0.1)
    tj, tt = _jt(rng, (B, cfg.ssm.d_conv - 1, conv_ch), "bfloat16")
    plan, jplan = make_plan(cfg, None), jax_make_plan(jcfg, None)
    oj, sj2, tj2 = jm2.mamba_seq(jcfg, jp, xj, jplan, sj, tj)
    ot, st2, tt2 = mamba2.mamba_seq(cfg, p, xt, plan, st, tt)
    np.testing.assert_allclose(_np(ot), _np(oj), **BF16)
    np.testing.assert_allclose(_np(st2), _np(sj2), **F32)
    np.testing.assert_array_equal(_np(tt2), _np(tj2))
    state, tail, outs = st, tt, []
    jstate, jtail = sj, tj
    for i in range(S):
        o, state, tail = mamba2.mamba_step(cfg, p, xt[:, i], state, tail)
        jo, jstate, jtail = jm2.mamba_step(jcfg, jp, xj[:, i], jstate, jtail)
        np.testing.assert_allclose(_np(o), _np(jo), err_msg=f"step {i}", **BF16)
        outs.append(o)
    np.testing.assert_allclose(_np(state), _np(jstate), **F32)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(ot), **BF16)
    assert_rel_l2(state, st2, 2e-2, "state, steps vs sequence")
    assert torch.equal(tail, tt2)


def test_group_sizes_and_cache_spec():
    for n, k, want in ((81, 27, [27, 27, 27]), (3, 2, [2, 1]), (2, 2, [2]), (5, 0, [5])):
        cfg = get_config("zamba2-7b").reduced(n_layers=n, attn_every=k)
        assert mamba2._group_sizes(cfg) == jm2._group_sizes(jax_get_config("zamba2-7b").reduced(
            n_layers=n, attn_every=k)) == want
    cfg = get_config("zamba2-7b")
    spec = mamba2.cache_spec(cfg, 8, 2080)
    assert spec["attn_k"] == ((3, 8, 2080, 32, 112), torch.bfloat16)
    assert spec["ssm"] == ((81, 8, 112, 64, 64), torch.float32)
    assert spec["conv"] == ((81, 8, 3, 7296), torch.bfloat16)
    jspec = jm2.cache_spec(jax_get_config("zamba2-7b"), 8, 2080)
    assert {k: v[0] for k, v in spec.items()} == {k: v.shape for k, v in jspec.items()}


# ---------------------------------------------------------------------------
# zamba2-7b (and its head_dim-112 variant) end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    arch = request.param
    jcfg, cfg = reduced_configs(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA + 1), dtype=np.int32)
    return dict(arch=arch, jcfg=jcfg, jmodel=jmodel, jparams=jparams, jplan=jax_make_plan(jcfg, None),
                cfg=cfg, model=build_model(cfg), params=params, plan=make_plan(cfg, None), tokens=tokens)


def test_loss_and_grads_match_reference(model_pair):
    mp = model_pair
    tokens, jplan = mp["tokens"], mp["jplan"]
    if mp["arch"].endswith("-d112"):
        assert mp["cfg"].resolved_head_dim == 112 and len(mamba2._group_sizes(mp["cfg"])) == 2
    n = S + EXTRA  # a multiple of the chunk
    jbatch = {"tokens": jnp.asarray(tokens[:, :n]), "labels": jnp.asarray(tokens[:, 1:n + 1])}
    batch = {"tokens": torch.from_numpy(tokens[:, :n]), "labels": torch.from_numpy(tokens[:, 1:n + 1])}
    (want, wm), jgrads = strict(
        jax.value_and_grad(lambda p, b: mp["jmodel"].loss(p, b, jplan), has_aux=True), mp["jparams"], jbatch)
    paths = list(tree_paths(mp["params"]))
    leaves = [leaf.detach().clone().requires_grad_(True) for _, leaf in paths]
    it = iter(leaves)
    params = tree_map(lambda _: next(it), mp["params"])
    got, gm = mp["model"].loss(params, batch, mp["plan"])
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    assert set(gm) == set(wm)
    jflat = {"/".join(k): v for k, v in tree_paths(from_jax_params(jax.device_get(jgrads), "cpu"))}
    assert "shared_attn/attn/wq" in jflat
    for (path, _), g in zip(paths, grads):
        w = jflat["/".join(path)].float()
        rel = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= TOL_GRAD, f"{mp['arch']} grad of {'/'.join(path)}: relative L2 error {rel}"


@torch.no_grad()
def test_prefill_and_decode_match_reference(model_pair):
    mp = model_pair
    cfg, tokens, jplan = mp["cfg"], mp["tokens"], mp["jplan"]
    jmodel, model = mp["jmodel"], mp["model"]
    jlast, jcache = strict(lambda p, t: jmodel.prefill(p, {"tokens": t}, jplan), mp["jparams"],
                           jnp.asarray(tokens[:, :S]))
    last, cache = model.prefill(mp["params"], {"tokens": torch.from_numpy(tokens[:, :S])}, mp["plan"])
    np.testing.assert_allclose(_np(last), _np(jlast), **LOGITS)
    assert set(cache) == set(jcache) == {"ssm", "conv", "attn_k", "attn_v"}
    assert cache["attn_k"].shape[0] == len(mamba2._group_sizes(cfg))  # one K/V an application
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        assert str(cache[name].dtype).replace("torch.", "") == jcache[name].dtype.name, name
        if name == "ssm":
            assert_rel_l2(cache[name], jcache[name], 2e-2, name)
        else:
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **LOGITS)

    jcache, cache = jax_pad_cache(jcache, EXTRA), serve_step.pad_cache(cache, EXTRA)
    assert cache["attn_k"].shape[2] == S + EXTRA and cache["ssm"].shape == jcache["ssm"].shape
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode(p, {"token": t}, c, pos, jplan))
    jdecode = jdecode.lower(mp["jparams"], jnp.asarray(tokens[:, S]), jcache, jnp.int32(S)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    for i in range(EXTRA):
        jlogits, jcache = jdecode(mp["jparams"], jnp.asarray(tokens[:, S + i]), jcache, jnp.int32(S + i))
        logits, cache = model.decode(mp["params"], {"token": torch.from_numpy(tokens[:, S + i])}, cache, S + i,
                                     mp["plan"])
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"decode step {i}", **LOGITS)
    assert_rel_l2(cache["ssm"], jcache["ssm"], 2e-2, "ssm")
    for name in ("conv", "attn_k", "attn_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **LOGITS)


@torch.no_grad()
@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_forward(arch):
    """Twin of tests/test_decode_consistency.py for zamba2-7b: the port's
    prefill and decode against its own forward, at its 6e-2."""
    _, cfg = reduced_configs(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    plan = make_plan(cfg, None)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA), dtype=np.int32))
    ref_logits = mamba2.forward(cfg, params, tokens, plan)
    last, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    np.testing.assert_allclose(_np(last), _np(ref_logits[:, S - 1]), **LOGITS)
    cache = serve_step.pad_cache(cache, EXTRA)
    for i in range(EXTRA):
        logits, cache = model.decode(params, {"token": tokens[:, S + i]}, cache, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(ref_logits[:, S + i]), err_msg=f"step {i}", **LOGITS)


def test_ssm_alias_builds_the_hybrid():
    """``ssm`` is the reference's alias of ``hybrid`` (pure-mamba configs)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), family="ssm", attn_every=0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert "shared_attn" not in params and set(model.cache_spec(2, 8)) == {"ssm", "conv"}
    last, cache = model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int32)}, make_plan(cfg, None))
    assert last.shape == (2, cfg.padded_vocab) and torch.isfinite(last).all()
    assert torch.equal(layer_params(params["layers"], 1)["w_in"], params["layers"]["w_in"][1])
