"""PyTorch port vs the JAX reference: the serving slice as a whole.

Reduced configs, weights converted from the reference's init, the same tokens
(numpy, seeded) through both: ``forward`` logits, ``prefill`` last logits and
cache, 8 ``decode`` steps. Tolerance atol = rtol = 6e-2, the reference's own
serving tolerance (tests/test_decode_consistency.py): the two frameworks
round to bf16 at other places. Logits are compared, not argmax tokens: bf16
ties break differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model_api import build_model as jax_build_model
from repro.runtime.serve_step import pad_cache as jax_pad_cache
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import mamba2, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model_api import build_model
from repro_torch.runtime import serve_step
from repro_torch.sharding.plan import make_plan

ARCHS = ["granite-3-2b", "qwen2-72b", "stablelm-12b", "stablelm-12b-d160", "olmoe-1b-7b", "zamba2-7b"]
TOL = dict(atol=6e-2, rtol=6e-2)
#: stablelm-shaped configs that keep its head_dim of 160 (the reduced ones
#: have 16): 2 layers, d_model 640, 4 heads over 1 KV head (G = 4), vocab 256
D160 = {"stablelm-12b-d160": ("stablelm-12b", dict(d_model=640, n_heads=4, n_kv_heads=1, head_dim=160,
                                                   d_ff=256, vocab=256))}


def reduced_configs(arch):
    """(reference config, port config) of ``arch`` reduced, or of a D160 entry."""
    name, overrides = D160.get(arch, (arch, {}))
    return jax_get_config(name).reduced(**overrides), get_config(name).reduced(**overrides)
B, S, EXTRA = 2, 16, 8


def _forward(cfg, params, tokens, plan, *, reference=False):
    """Full-sequence logits (B, S, V) through the family's ``forward``."""
    tfm_, moe_, mamba2_ = (jtfm, jmoe, jmamba2) if reference else (tfm, moe, mamba2)
    if cfg.family == "moe":
        return moe_.forward(cfg, params, tokens, plan)[0]
    if cfg.family == "hybrid":
        return mamba2_.forward(cfg, params, tokens, plan)
    return tfm_.forward(cfg, params, tokens, plan)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _setup(arch):
    jcfg, cfg = reduced_configs(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg)
    params = from_jax_params(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA), dtype=np.int32)
    return (jcfg, jmodel, jparams, jax_make_plan(jcfg, None)), (cfg, model, params, make_plan(cfg, None)), tokens


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_forward_logits_match_reference(arch):
    (jcfg, _, jparams, jplan), (cfg, _, params, plan), tokens = _setup(arch)
    want = _forward(jcfg, jparams, jnp.asarray(tokens), jplan, reference=True)
    got = _forward(cfg, params, torch.from_numpy(tokens), plan)
    assert got.shape == (B, S + EXTRA, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_loss_matches_reference(arch):
    (_, jmodel, jparams, jplan), (cfg, model, params, plan), tokens = _setup(arch)
    if cfg.family == "hybrid":  # the chunked scan takes a multiple of the chunk: S + EXTRA tokens
        more = np.random.default_rng(2).integers(0, cfg.vocab, (B, 1), dtype=np.int32)
        tokens = np.concatenate([tokens, more], axis=1)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:])}
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:])}
    want, wm = jmodel.loss(jparams, jbatch, jplan)
    got, gm = model.loss(params, batch, plan)
    # the variants' loss tolerance of the reference (tests/test_variants.py)
    np.testing.assert_allclose(got.item(), float(want), atol=3e-2, rtol=3e-2)
    assert set(gm) == set(wm)


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_prefill_and_decode_match_reference(arch):
    (_, jmodel, jparams, jplan), (cfg, model, params, plan), tokens = _setup(arch)
    jlast, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])}, jplan)
    last, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])}, plan)
    assert last.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    assert set(cache) == set(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        if name == "ssm":  # f32 states over bf16 inputs: held as a whole, at bf16's 2e-2
            assert np.linalg.norm(_np(cache[name]) - _np(jcache[name])) <= 2e-2 * np.linalg.norm(_np(jcache[name]))
            continue
        assert cache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL)

    jcache = jax_pad_cache(jcache, EXTRA)
    cache = serve_step.pad_cache(cache, EXTRA)
    kv = "attn_k" if cfg.family == "hybrid" else "k"
    assert cache[kv].shape == jcache[kv].shape and cache[kv].shape[2] == S + EXTRA
    for i in range(EXTRA):
        jlogits, jcache = jmodel.decode(jparams, {"token": jnp.asarray(tokens[:, S + i])}, jcache, S + i, jplan)
        logits, cache = model.decode(params, {"token": torch.from_numpy(tokens[:, S + i])}, cache, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"{arch}: decode step {i}", **TOL)
    np.testing.assert_allclose(_np(cache[kv]), _np(jcache[kv]), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["llava-next-34b"])
@torch.no_grad()
def test_incremental_decode_matches_forward(arch):
    """Twin of the reference's test of the same name: the port against itself."""
    _, (cfg, model, params, plan), tokens = _setup(arch)
    tokens = torch.from_numpy(tokens)
    ref_logits = _forward(cfg, params, tokens, plan)
    last, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    np.testing.assert_allclose(_np(last), _np(ref_logits[:, S - 1]), **TOL)
    cache = serve_step.pad_cache(cache, EXTRA)
    for i in range(EXTRA):
        logits, cache = model.decode(params, {"token": tokens[:, S + i]}, cache, S + i, plan)
        np.testing.assert_allclose(_np(logits), _np(ref_logits[:, S + i]), err_msg=f"step {i}", **TOL)


@torch.no_grad()
def test_decode_updates_the_cache_in_place():
    _, (cfg, model, params, plan), tokens = _setup("granite-3-2b")
    tokens = torch.from_numpy(tokens)
    _, cache = model.prefill(params, {"tokens": tokens[:, :S]}, plan)
    padded = serve_step.pad_cache(cache, EXTRA)
    assert cache["k"].shape[2] == S and padded["k"].shape[2] == S + EXTRA  # pad_cache copies
    assert torch.equal(padded["k"][:, :, :S], cache["k"]) and not padded["k"][:, :, S:].any()
    kept = {k: v.clone() for k, v in padded.items()}
    _, new_cache = model.decode(params, {"token": tokens[:, S]}, padded, S, plan)
    assert new_cache["k"].data_ptr() == padded["k"].data_ptr()
    assert torch.equal(padded["k"][:, :, :S], kept["k"][:, :, :S])
    assert padded["k"][:, :, S].any() and not torch.equal(padded["v"], kept["v"])
    assert not padded["k"][:, :, S + 1:].any()


@torch.no_grad()
def test_patch_stub_matches_reference():
    arch = "llava-next-34b"
    (jcfg, jmodel, jparams, jplan), (cfg, model, params, plan), tokens = _setup(arch)
    patches = np.random.default_rng(2).standard_normal((B, cfg.n_patches, cfg.d_model), dtype=np.float32)
    jlast, _ = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S]), "patches": jnp.asarray(patches)}, jplan
    )
    last, _ = model.prefill(
        params, {"tokens": torch.from_numpy(tokens[:, :S]), "patches": torch.from_numpy(patches)}, plan
    )
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)


def test_logit_softcap_and_pad_mask_match_reference():
    jcfg = jax_get_config("granite-3-2b").reduced(vocab=250, logit_softcap=5.0)
    cfg = get_config("granite-3-2b").reduced(vocab=250, logit_softcap=5.0)
    assert cfg.padded_vocab == 256
    jparams = jax_build_model(jcfg).init(jax.random.key(3))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    h = np.random.default_rng(4).standard_normal((2, 3, cfg.d_model), dtype=np.float32) * 4
    want = jtfm.logits_fn(jcfg, jparams, jnp.asarray(h).astype(jnp.bfloat16), jax_make_plan(jcfg, None))
    with torch.no_grad():
        got = tfm.logits_fn(cfg, params, torch.from_numpy(h).bfloat16(), make_plan(cfg, None))
    assert got.dtype == torch.float32  # the softcap upcasts, as in the reference
    np.testing.assert_allclose(_np(got[..., :250]), _np(want[..., :250]), **TOL)
    assert (got[..., 250:] == -1e30).all() and (np.asarray(want[..., 250:]) == np.float32(-1e30)).all()


@torch.no_grad()
@pytest.mark.parametrize("arch", ["qwen2-72b", "olmoe-1b-7b", "zamba2-7b"])
def test_greedy_generate_and_step_builders(arch):
    _, (cfg, model, params, plan), tokens = _setup(arch)
    prompt = torch.from_numpy(tokens[:, :S])
    out = serve_step.greedy_generate(model, params, prompt, 5, plan)
    assert out.shape == (B, 5) and out.dtype == torch.int32
    assert (out >= 0).all() and (out < cfg.vocab).all()  # pad ids are never emitted
    last, cache = serve_step.build_prefill(model, plan)(params, {"tokens": prompt})
    assert torch.equal(torch.argmax(last, -1).to(torch.int32), out[:, 0])
    cache = serve_step.pad_cache(cache, 4)
    logits, _ = serve_step.build_decode(model, plan, S)(params, {"token": out[:, 0]}, cache)
    assert torch.equal(torch.argmax(logits, -1).to(torch.int32), out[:, 1])


def test_families_outside_the_slice_raise_key_error():
    """Every family of the registry builds now (tests/test_torch_convert.py
    holds each arch's param count); a family the port does not know raises."""
    import dataclasses

    for arch in ("olmoe-1b-7b", "whisper-base", "zamba2-7b"):
        assert build_model(get_config(arch)).cfg.name == arch
    with pytest.raises(KeyError, match="unknown family"):
        build_model(dataclasses.replace(get_config("granite-3-2b"), family="no-such-family"))
    spec = build_model(get_config("granite-3-2b")).cache_spec(8, 2080)
    assert spec["k"] == ((40, 8, 2080, 8, 64), torch.bfloat16)
