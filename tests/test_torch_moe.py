"""PyTorch port vs the JAX reference: the MoE family (``models/moe.py``).

The router, top-k, sort-based dispatch and combine and the load-balance loss
on the same arrays; ``moe_ffn`` with and without shared experts; then
olmoe-1b-7b and deepseek-moe-16b reduced (2 layers, d 64, 8 experts, top-2,
capacity factor 8), weights converted from the reference's init: the loss
with its ``aux_loss`` and ``router_z`` terms, every gradient, prefill and 8
decode steps. Inputs are made with numpy from a seed.

The reference runs compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so that it rounds to bf16 wherever
its program says so, as PyTorch's eager ops do; with it on, XLA keeps some
bf16 intermediates in f32 and the two hidden states differ by an ulp.
Routing is discontinuous: an ulp moves a near-tie of two router
probabilities, and a token that takes another expert moves the logits by
O(1). Each end-to-end test counts the (layer, token) top-k sets on which
the two packages differ, and asserts that there are none.

Tolerances are the reference tests': f32 2e-5, bf16 2e-2, logits 6e-2,
loss 3e-2; each gradient leaf to a relative L2 error of 2e-2, bf16's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.model_api import build_model as jax_build_model
from repro.runtime.serve_step import pad_cache as jax_pad_cache
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import moe
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_map, tree_paths
from repro_torch.runtime import serve_step
from repro_torch.sharding.plan import make_plan

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
LOGITS = dict(atol=6e-2, rtol=6e-2)
LOSS = dict(atol=3e-2, rtol=3e-2)
TOL_GRAD = 2e-2  # relative L2 error of each gradient leaf
ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]
B, S, EXTRA = 2, 16, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def strict(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off (see above)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _jt(rng, shape, dtype="float32", scale=1.0):
    a = (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# router, top-k, dispatch, combine, load balance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("renormalize", [True, False])
def test_router_probs_and_top_k_gates(renormalize):
    rng = np.random.default_rng(0)
    xj, xt = _jt(rng, (48, 64), "bfloat16")
    wj, wt = _jt(rng, (64, 8), scale=0.3)
    pj, lj = jmoe.router_probs({"w_router": wj}, xj)
    pt, lt = moe.router_probs({"w_router": wt}, xt)
    assert pt.dtype == lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj), **F32)
    np.testing.assert_allclose(_np(pt), _np(pj), **F32)
    vj, ij = jmoe.top_k_gates(pj, 3, renormalize)
    vt, it = moe.top_k_gates(pt, 3, renormalize)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(_np(vt), _np(vj), **F32)


def _dispatch_inputs(rng, T, k, E, d=16):
    xj, xt = _jt(rng, (T, d), "bfloat16")
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    return (xj, jnp.asarray(idx), jnp.asarray(gates)), (xt, torch.from_numpy(idx), torch.from_numpy(gates))


DISPATCH_CASES = [
    # (T, k, E, capacity, expert_lo, n_local)
    (24, 2, 8, 16, 0, None),  # room for every assignment
    (40, 3, 4, 16, 0, None),  # 120 assignments in 64 slots: tokens are dropped
    (24, 2, 8, 8, 2, 3),      # the expert range [2, 5) alone, with drops
]


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_sort_dispatch_and_combine(case):
    T, k, E, C, lo, n_local = case
    rng = np.random.default_rng(1)
    (xj, ij, gj), (xt, it, gt) = _dispatch_inputs(rng, T, k, E)
    want, jinfo = jmoe.sort_dispatch(xj, ij, gj, E, C, lo, n_local)
    got, info = moe.sort_dispatch(xt, it, gt, E, C, lo, n_local)
    assert tuple(got.shape) == want.shape == ((n_local or E), C, 16)
    np.testing.assert_array_equal(_np(got), _np(want))  # rows are copied, never summed
    for name, a, b in zip(("st", "sg", "slot", "keep"), info, jinfo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    keep = info[3].numpy()
    if case[1:3] == (3, 4) or n_local:
        assert 0 < keep.sum() < T * k  # some assignments dropped, some kept
    else:
        assert keep.all()

    oj, ot = _jt(rng, want.shape, "bfloat16")
    np.testing.assert_allclose(_np(moe.sort_combine(ot, info, T)), _np(jmoe.sort_combine(oj, jinfo, T)), **BF16)
    # the batch as a leading dim gives each example's result
    batched, binfo = moe.sort_dispatch(xt[None].expand(2, T, 16), it[None].expand(2, T, k),
                                       gt[None].expand(2, T, k), E, C, lo, n_local)
    assert torch.equal(batched[1], got) and all(torch.equal(a[1], b) for a, b in zip(binfo, info))
    assert torch.equal(moe.sort_combine(ot[None].expand(2, *ot.shape), binfo, T)[1], moe.sort_combine(ot, info, T))


def test_sort_combine_sums_in_the_sorted_order():
    """A token's k rows are added one after the other in the order of the
    sorted assignments (bf16 rounding after each add), whatever the device's
    atomics would do: the same bits on every run."""
    rng = np.random.default_rng(2)
    _, (xt, it, gt) = _dispatch_inputs(rng, 16, 4, 8)
    grouped, info = moe.sort_dispatch(xt, it, gt, 8, 16)
    out = torch.from_numpy(rng.standard_normal(grouped.shape, dtype=np.float32) * 100).bfloat16()
    st, sg, slot, keep = info
    rows = out.reshape(-1, 16)[slot] * (sg * keep)[:, None].bfloat16()
    want = torch.zeros((16, 16), dtype=torch.bfloat16)
    for i in range(len(st)):  # the reference's scatter-add, assignment by assignment
        want[st[i]] = want[st[i]] + rows[i]
    assert torch.equal(moe.sort_combine(out, info, 16), want)


def test_load_balance_loss():
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(8), 40).astype(np.float32)
    idx = rng.integers(0, 8, (40, 2)).astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 8)
    got = moe.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(idx), 8)
    np.testing.assert_allclose(float(got), float(want), **F32)


@pytest.mark.parametrize("S,k,E,cf,want", [
    (1, 6, 64, 1.25, 8),        # a decode step: 8 slots, nothing dropped
    (2048, 6, 64, 1.25, 240),   # deepseek-moe-16b's prefill on the card
    (4096, 8, 64, 1.25, 640),   # olmoe-1b-7b's train step on the card
    (16, 2, 8, 8.0, 32),        # the reduced configs
    (7, 3, 4, 0.5, 8),          # at least 8
    (100, 3, 8, 1.0, 40),       # ceil(37.5) = 38, up to a multiple of 8
])
def test_capacity_rule(S, k, E, cf, want):
    """ceil(S k / E cf), at least 8 and a multiple of 8: the reference's
    rule (moe.py's moe_ffn), which decides what prefill drops."""
    assert moe.capacity_of(S, k, E, cf) == want


@pytest.mark.parametrize("arch", ARCHS)  # olmoe: no shared expert; deepseek: one (reduced)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    assert bool(cfg.moe.n_shared) == (arch == "deepseek-moe-16b")
    jp = jmoe.init_moe_ffn(jcfg, jax.random.key(4))
    p = from_jax_params(jax.device_get(jp), "cpu")
    assert ("shared" in p) == bool(cfg.moe.n_shared)
    rng = np.random.default_rng(5)
    xj, xt = _jt(rng, (B, S, cfg.d_model), "bfloat16")
    yj, auxj = jmoe.moe_ffn(jcfg, jp, xj, jax_make_plan(jcfg, None), capacity_factor)
    yt, auxt = moe.moe_ffn(cfg, p, xt, make_plan(cfg, None), capacity_factor)
    assert yt.shape == (B, S, cfg.d_model) and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj), **BF16)
    for name in ("aux_loss", "router_z"):
        np.testing.assert_allclose(float(auxt[name]), float(auxj[name]), **F32, err_msg=name)


# ---------------------------------------------------------------------------
# olmoe-1b-7b and deepseek-moe-16b end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    """One reference model and its port per arch, the weights converted, and
    the tokens (numpy, seeded): shared by the end-to-end tests below."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA + 1), dtype=np.int32)
    return dict(arch=arch, jcfg=jcfg, jmodel=jmodel, jparams=jparams, jplan=jax_make_plan(jcfg, None),
                cfg=cfg, model=build_model(cfg), params=params, plan=make_plan(cfg, None), tokens=tokens)


@pytest.fixture
def routes(monkeypatch):
    """Records the top-k expert ids of every MoE layer call in both packages
    (the reference's through a debug callback, which runs compiled)."""
    got = {"ref": [], "port": []}
    jtop, ttop = jmoe.top_k_gates, moe.top_k_gates

    def jrec(probs, k, renormalize=True):
        vals, idx = jtop(probs, k, renormalize)
        jax.debug.callback(lambda i: got["ref"].append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    def trec(probs, k, renormalize=True):
        vals, idx = ttop(probs, k, renormalize)
        got["port"].append(idx.numpy().copy())
        return vals, idx

    monkeypatch.setattr(jmoe, "top_k_gates", jrec)
    monkeypatch.setattr(moe, "top_k_gates", trec)
    return got


def routing_differences(routes) -> int:
    """(layer call, token) rows whose top-k sets differ between the packages."""
    assert len(routes["ref"]) == len(routes["port"]) > 0
    return sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum()) for a, b in zip(routes["ref"], routes["port"]))


def test_loss_and_grads_match_reference(model_pair, routes):
    mp = model_pair
    cfg, tokens = mp["cfg"], mp["tokens"]
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:])}
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:])}
    jplan = mp["jplan"]
    (want, wm), jgrads = strict(
        jax.value_and_grad(lambda p, b: mp["jmodel"].loss(p, b, jplan), has_aux=True), mp["jparams"], jbatch)
    paths = list(tree_paths(mp["params"]))
    leaves = [leaf.detach().clone().requires_grad_(True) for _, leaf in paths]
    it = iter(leaves)
    params = tree_map(lambda _: next(it), mp["params"])
    got, gm = mp["model"].loss(params, batch, mp["plan"])
    grads = torch.autograd.grad(got, leaves)
    got = got.detach()
    flips = routing_differences(routes)
    print(f"{mp['arch']}: top-k sets that differ between the packages: {flips}")
    assert flips == 0
    np.testing.assert_allclose(float(got), float(want), **LOSS)
    assert set(gm) == set(wm) and "aux_loss" in gm
    np.testing.assert_allclose(float(gm["aux_loss"].detach()), float(wm["aux_loss"]), **F32)
    # the total is ce + z_loss term + the router terms, summed over the layers
    _, aux = moe.forward(cfg, mp["params"], batch["tokens"], mp["plan"])
    L, m = cfg.n_layers, cfg.moe
    router = m.router_aux_coef * aux["aux_loss"] / L + m.router_z_coef * aux["router_z"] / L
    total = got - gm["ce"].detach() - 1e-4 * gm["z_loss"].detach()
    np.testing.assert_allclose(float(total), float(router), rtol=1e-5, atol=1e-6)
    jflat = {"/".join(k): v for k, v in tree_paths(from_jax_params(jax.device_get(jgrads), "cpu"))}
    for (path, _), g in zip(paths, grads):
        w = jflat["/".join(path)].float()
        rel = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= TOL_GRAD, f"{mp['arch']} grad of {'/'.join(path)}: relative L2 error {rel}"


@torch.no_grad()
def test_prefill_and_decode_match_reference(model_pair, routes):
    mp = model_pair
    cfg, tokens, jplan = mp["cfg"], mp["tokens"], mp["jplan"]
    jmodel, model = mp["jmodel"], mp["model"]
    jlast, jcache = strict(lambda p, t: jmodel.prefill(p, {"tokens": t}, jplan), mp["jparams"],
                           jnp.asarray(tokens[:, :S]))
    last, cache = model.prefill(mp["params"], {"tokens": torch.from_numpy(tokens[:, :S])}, mp["plan"])
    assert last.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(_np(last), _np(jlast), **LOGITS)
    assert set(cache) == set(jcache) == {"k", "v"}
    for name in cache:
        assert cache[name].shape == jcache[name].shape and cache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **LOGITS)

    jcache, cache = jax_pad_cache(jcache, EXTRA), serve_step.pad_cache(cache, EXTRA)
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode(p, {"token": t}, c, pos, jplan))
    jdecode = jdecode.lower(mp["jparams"], jnp.asarray(tokens[:, S]), jcache, jnp.int32(S)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    for i in range(EXTRA):
        jlogits, jcache = jdecode(mp["jparams"], jnp.asarray(tokens[:, S + i]), jcache, jnp.int32(S + i))
        logits, cache = model.decode(mp["params"], {"token": torch.from_numpy(tokens[:, S + i])}, cache, S + i,
                                     mp["plan"])
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"decode step {i}", **LOGITS)
    np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]), **LOGITS)
    flips = routing_differences(routes)
    print(f"{mp['arch']}: top-k sets that differ between the packages: {flips}")
    assert flips == 0


@torch.no_grad()
def test_incremental_decode_matches_forward():
    """Twin of tests/test_decode_consistency.py for olmoe-1b-7b: the port's
    prefill and decode against its own forward, at its 6e-2."""
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    plan = make_plan(cfg, None)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA), dtype=np.int32))
    ref_logits, _ = moe.forward(cfg, params, tokens, plan)
    last, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    np.testing.assert_allclose(_np(last), _np(ref_logits[:, S - 1]), **LOGITS)
    cache = serve_step.pad_cache(cache, EXTRA)
    for i in range(EXTRA):
        logits, cache = model.decode(params, {"token": tokens[:, S + i]}, cache, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(ref_logits[:, S + i]), err_msg=f"step {i}", **LOGITS)


def test_expert_init_takes_the_reference_fan_in():
    """The reference initializes one layer's (E, d, f) expert weights with a
    fan-in of E (its leading dim); the port keeps that std, stacked or not."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), n_layers=1)
    p = moe.init_moe_ffn(cfg, torch.Generator().manual_seed(0), "cpu", (3,))
    E = cfg.moe.n_experts
    assert p["e_gate"].shape == (3, E, cfg.d_model, cfg.moe.d_expert)
    # truncated at 2 sigma: the std of the draws is 0.88 of the normal's
    np.testing.assert_allclose(float(p["e_gate"].float().std()), 0.88 / E**0.5, rtol=0.05)
    np.testing.assert_allclose(float(p["w_router"].float().std()), 0.88 / cfg.d_model**0.5, rtol=0.05)
