"""PyTorch port vs the JAX reference: the encoder-decoder (``models/encdec.py``).

Whisper's sinusoidal positions, the encoder, then whisper-base reduced (2 + 2
layers, d 64, 8 frames): the loss and every gradient, prefill with its self
and cross caches, and 8 decode steps, weights converted from the reference's
init, tokens and frames made with numpy from a seed. Whisper is served
through ``model.prefill`` and ``model.decode`` with a frames batch, as the
reference's own tests serve it: ``greedy_generate`` passes tokens only, in
both packages.

The reference runs compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so that it rounds to bf16 where its
program says so, as PyTorch's eager ops do. Tolerances are the reference
tests': f32 2e-5, bf16 2e-2, logits 6e-2, loss 3e-2; each gradient leaf to
a relative L2 error of 2e-2, bf16's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import encdec as jed
from repro.models.model_api import build_model as jax_build_model
from repro.runtime.serve_step import pad_cache as jax_pad_cache
from repro.sharding.plan import make_plan as jax_make_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import encdec
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_map, tree_paths
from repro_torch.runtime import serve_step
from repro_torch.sharding.plan import make_plan

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
LOGITS = dict(atol=6e-2, rtol=6e-2)
LOSS = dict(atol=3e-2, rtol=3e-2)
TOL_GRAD = 2e-2  # relative L2 error of each gradient leaf
ARCH = "whisper-base"
B, S, EXTRA = 2, 16, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def strict(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off (see above)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("length,channels", [(8, 64), (1500, 512), (7, 6)])
def test_sinusoids(length, channels):
    """f32, but the angles reach length - 1 radians, where one f32 ulp is
    larger than 2e-5 (1.2e-4 at 1499): there the two libraries' exp and sin
    may differ by two ulps of the angle."""
    got = encdec.sinusoids(length, channels)
    assert got.dtype == torch.float32 and got.shape == (length, channels)
    atol = max(F32["atol"], 2 * float(np.spacing(np.float32(length - 1))))
    np.testing.assert_allclose(got.numpy(), np.asarray(jed.sinusoids(length, channels)), atol=atol, rtol=F32["rtol"])


@pytest.fixture(scope="module")
def pair():
    """The reference model and its port, the weights converted, and the
    tokens and frames (numpy, seeded): shared by the tests below."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S + EXTRA + 1), dtype=np.int32)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model), dtype=np.float32)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jplan=jax_make_plan(jcfg, None), cfg=cfg,
                model=build_model(cfg), params=from_jax_params(jax.device_get(jparams), "cpu"),
                plan=make_plan(cfg, None), tokens=tokens, jframes=jnp.asarray(frames).astype(jnp.bfloat16),
                frames=torch.from_numpy(frames).bfloat16())


@torch.no_grad()
def test_encode_matches_reference(pair):
    jplan = pair["jplan"]
    want = strict(lambda p, f: jed.encode(pair["jcfg"], p, f, jplan), pair["jparams"], pair["jframes"])
    got = encdec.encode(pair["cfg"], pair["params"], pair["frames"], pair["plan"])
    assert got.shape == (B, pair["cfg"].n_frames, pair["cfg"].d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_loss_and_grads_match_reference(pair):
    tokens, jplan = pair["tokens"], pair["jplan"]
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:]), "frames": pair["jframes"]}
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:]),
             "frames": pair["frames"]}
    (want, wm), jgrads = strict(
        jax.value_and_grad(lambda p, b: pair["jmodel"].loss(p, b, jplan), has_aux=True), pair["jparams"], jbatch)
    paths = list(tree_paths(pair["params"]))
    leaves = [leaf.detach().clone().requires_grad_(True) for _, leaf in paths]
    it = iter(leaves)
    params = tree_map(lambda _: next(it), pair["params"])
    got, gm = pair["model"].loss(params, batch, pair["plan"])
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    assert set(gm) == set(wm)
    jflat = {"/".join(k): v for k, v in tree_paths(from_jax_params(jax.device_get(jgrads), "cpu"))}
    assert {"enc_layers/attn/wk", "dec_layers/cross_attn/bq", "dec_pos/table", "frame_proj/w_in"} <= set(jflat)
    for (path, _), g in zip(paths, grads):
        w = jflat["/".join(path)].float()
        rel = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= TOL_GRAD, f"grad of {'/'.join(path)}: relative L2 error {rel}"


@torch.no_grad()
def test_prefill_and_decode_match_reference(pair):
    cfg, tokens, jplan = pair["cfg"], pair["tokens"], pair["jplan"]
    jmodel, model = pair["jmodel"], pair["model"]
    jlast, jcache = strict(lambda p, t, f: jmodel.prefill(p, {"tokens": t, "frames": f}, jplan),
                           pair["jparams"], jnp.asarray(tokens[:, :S]), pair["jframes"])
    last, cache = model.prefill(pair["params"], {"tokens": torch.from_numpy(tokens[:, :S]),
                                                 "frames": pair["frames"]}, pair["plan"])
    np.testing.assert_allclose(_np(last), _np(jlast), **LOGITS)
    assert set(cache) == set(jcache) == {"k", "v", "xk", "xv"}
    assert cache["xk"].shape == (cfg.n_layers, B, cfg.n_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
    for name in cache:
        assert cache[name].shape == jcache[name].shape and cache[name].dtype == torch.bfloat16, name
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **LOGITS)

    # pad_cache grows the self-attention caches and leaves the cross caches as they are
    jcache, cache = jax_pad_cache(jcache, EXTRA), serve_step.pad_cache(cache, EXTRA)
    assert cache["k"].shape[2] == S + EXTRA and cache["xk"].shape[2] == cfg.n_frames
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode(p, {"token": t}, c, pos, jplan))
    jdecode = jdecode.lower(pair["jparams"], jnp.asarray(tokens[:, S]), jcache, jnp.int32(S)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    xk = cache["xk"].clone()
    for i in range(EXTRA):
        jlogits, jcache = jdecode(pair["jparams"], jnp.asarray(tokens[:, S + i]), jcache, jnp.int32(S + i))
        logits, cache = model.decode(pair["params"], {"token": torch.from_numpy(tokens[:, S + i])}, cache, S + i,
                                     pair["plan"])
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"decode step {i}", **LOGITS)
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **LOGITS)
    assert torch.equal(cache["xk"], xk)  # decode reads the cross caches and never writes them


@torch.no_grad()
def test_decode_matches_prefill_path(pair):
    """Twin of tests/test_decode_consistency.py's whisper test: one decode step
    after a prefill of S tokens gives the last logits of a prefill of S + 1."""
    model, params, plan, frames = pair["model"], pair["params"], pair["plan"], pair["frames"]
    tokens = torch.from_numpy(pair["tokens"][:, : S + 1])
    last_ref, _ = model.prefill(params, {"tokens": tokens, "frames": frames}, plan)
    _, cache = model.prefill(params, {"tokens": tokens[:, :S], "frames": frames}, plan)
    logits, _ = model.decode(params, {"token": tokens[:, S], "frames": frames},
                             serve_step.pad_cache(cache, 1), S, plan)
    np.testing.assert_allclose(_np(logits), _np(last_ref), **LOGITS)


@torch.no_grad()
def test_decode_shares_one_length_copy_per_step(pair, monkeypatch):
    """Both decode attentions of every layer get their kv_len as 1-element
    int32 device tensors (self: pos + 1, cross: n_frames), views of one
    tensor a step, not a Python int that each call would copy to the device."""
    seen = []
    from repro_torch.models import transformer

    real = transformer.decode_attention

    def spy(q, kc, vc, *, kv_len, scale=None):
        seen.append(kv_len)
        return real(q, kc, vc, kv_len=kv_len, scale=scale)

    monkeypatch.setattr(transformer, "decode_attention", spy)
    cfg, model, params, plan = pair["cfg"], pair["model"], pair["params"], pair["plan"]
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(pair["tokens"][:, :S]), "frames": pair["frames"]},
                             plan)
    model.decode(params, {"token": torch.from_numpy(pair["tokens"][:, S])}, serve_step.pad_cache(cache, 2), S, plan)
    assert len(seen) == 2 * cfg.n_layers
    assert all(isinstance(t, torch.Tensor) and t.numel() == 1 and t.dtype == torch.int32 for t in seen)
    assert [int(t) for t in seen[:2]] == [S + 1, cfg.n_frames]
    assert len({t.untyped_storage().data_ptr() for t in seen}) == 1
