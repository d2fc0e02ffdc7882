"""The sharded steps of the vlm, moe and encdec families against the JAX
reference's, on a 1 x 1 mesh in this process (a one-rank gloo group over a
``FileStore`` in ``tmp_path``), as ``test_torch_mesh.py`` holds the dense
family's: llava-next-34b, olmoe-1b-7b, deepseek-moe-16b and whisper-base,
reduced, from converted weights and one seeded batch.

* ``jit_train_step`` (baseline, sp): two steps, loss to 3e-2 and the gradient
  norm to 3e-2 of the reference's (tests/test_variants.py's tolerance);
* ``jit_prefill_step`` and ``jit_decode_step`` (baseline, serve): the last
  logits and every cache the prefill writes, then one decode step from the
  reference's prefilled cache, at 6e-2.

The MoE archs route by their own router in both packages: nothing is
replayed. Last, two MoE archs of different top-k run on one layout in one
process, each against its single-device path. The multi-rank semantics (2 x 4) are held by the per-family files
``test_torch_mesh_{vlm,moe,encdec}.py``, against the port's single-device path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import Mesh

from repro.configs import base as jbase
from repro.configs.registry import CONFIGS as JCONFIGS
from repro.models.model_api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.runtime import serve_step as jserve
from repro.runtime import train_step as jts
from repro_torch.configs import base
from repro_torch.configs.registry import CONFIGS
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.models.model_api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import serve_step as serve
from repro_torch.runtime import train_step as ts
from repro_torch.sharding import dist
from repro_torch.sharding.plan import make_plan
from torch_mesh_family import RECURRENT_CACHES

ARCHS = ["llava-next-34b", "olmoe-1b-7b", "deepseek-moe-16b", "whisper-base"]
#: the recurrent families and resnet, which trains only
TRAIN_ARCHS = ARCHS + ["rwkv6-1.6b", "zamba2-7b", "resnet_small"]
SERVE_ARCHS = ARCHS + ["rwkv6-1.6b", "zamba2-7b"]
#: read (the largest over the variants): loss 1.7e-4 (llava), 3.8e-3
#: (olmoe), 3.5e-3 (deepseek), 4.1e-4 (whisper); gradient norm 6e-4, 2e-3,
#: 3.8e-3, 4.5e-4 of the reference's; prefill logits 0.017, 0.0078, 0.016,
#: 0.016; caches at most 0.016; decode logits 0.035, 0.037, 0.051, 0.021
TOL_LOSS, TOL_LOGITS = 3e-2, 6e-2
B, S_TRAIN, S_PROMPT = 8, 32, 31


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (FileStore in tmp_path: no port) and its 1 x 1 mesh."""
    tdist.init_process_group("gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh_shape((1, 1), ("data", "model"), device="cpu")
    finally:
        tdist.destroy_process_group()


def _jmesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _strict(jitted, *args):
    """The reference's jitted step run on ``args``, compiled with XLA's excess
    precision off, so that its bf16 values are rounded where the port's are
    (tests/test_torch_moe.py's rule: on a near-tie a router otherwise picks
    other experts in the two packages)."""
    return jitted.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(x) -> np.ndarray:
    """f32 numpy of a jax array, a tensor or a DTensor (whole)."""
    if isinstance(x, torch.Tensor):
        return dist.full(x).detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("variant", ["baseline", "sp"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_jit_train_step_of_each_family_on_one_device_mesh_matches_the_reference(arch, variant, one_rank):
    jcfg, cfg = JCONFIGS[arch].reduced(), CONFIGS[arch].reduced()
    jsuite, suite = jbase.ShapeSuite("t", S_TRAIN, B, "train"), base.ShapeSuite("t", S_TRAIN, B, "train")
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jopt = jadamw.AdamWConfig(warmup_steps=1, total_steps=10)
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    batch = synthetic.batch_for(cfg, suite, seed=0)

    jstep, jst_sh, jb_sh, _ = jts.jit_train_step(jmodel, _jmesh(), jsuite, jopt, variant=variant)
    jstate0 = jts.init_train_state(jmodel, jax.random.key(0), jopt)
    state0 = from_jax_train_state(jax.device_get(jstate0), "cpu")
    jstate = jax.device_put(jstate0, jst_sh)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jb_sh)

    step, st_sh, b_sh, _ = ts.jit_train_step(model, one_rank, suite, opt, variant=variant)
    state = dist.distribute(state0, st_sh)
    b = dist.distribute(from_jax_params(batch, "cpu"), b_sh)
    assert all(dist.is_dtensor(p) for p in b.values())
    for i in range(2):
        jstate, jm = _strict(jstep, jstate, jb)
        state, m = step(state, b)
        assert abs(float(m["loss"]) - float(jm["loss"])) < TOL_LOSS, (i, float(m["loss"]), float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) < TOL_LOSS * float(jm["grad_norm"]), \
            (i, float(m["grad_norm"]), float(jm["grad_norm"]))


@pytest.mark.parametrize("variant", ["baseline", "serve"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_jit_prefill_and_decode_steps_of_each_family_on_one_device_mesh_match_the_reference(arch, variant, one_rank):
    jcfg, cfg = JCONFIGS[arch].reduced(), CONFIGS[arch].reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    S = _prompt_len(cfg)
    prompt = synthetic.batch_for(cfg, base.ShapeSuite("p", S, B, "prefill"), seed=0)
    prompt.pop("labels", None)

    jpsuite, psuite = jbase.ShapeSuite("p", S, B, "prefill"), base.ShapeSuite("p", S, B, "prefill")
    jstep, jp_sh, jb_sh, _ = jserve.jit_prefill_step(jmodel, _jmesh(), jpsuite, variant=variant)
    jlast, jcache = _strict(jstep, jax.device_put(jparams, jp_sh),
                            jax.device_put({k: jnp.asarray(v) for k, v in prompt.items()}, jb_sh))
    step, p_sh, b_sh, _ = serve.jit_prefill_step(model, one_rank, psuite, variant=variant)
    tparams = dist.distribute(params, p_sh)
    last, cache = step(tparams, dist.distribute(from_jax_params(prompt, "cpu"), b_sh))
    err = float(np.max(np.abs(_np(last) - _np(jlast))))
    assert err < TOL_LOGITS, ("prefill logits", err)
    assert set(cache) == set(jcache)
    for name in cache:
        assert dist.is_dtensor(cache[name]) and tuple(cache[name].shape) == tuple(jcache[name].shape), name
        err = _cache_err(name, _np(cache[name]), _np(jcache[name]))
        assert err < TOL_LOGITS, ("prefill cache", name, err)

    # one decode step from the reference's prefilled cache, grown by a slot
    jcache = jax.device_get(jserve.pad_cache(jcache, 1))  # on the host: the jitted step donates its copy
    tok = np.array(jnp.argmax(jlast, -1).astype(jnp.int32))
    inputs = {"token": tok}
    if cfg.enc_layers:
        inputs["frames"] = prompt["frames"]
    jdsuite, dsuite = jbase.ShapeSuite("d", S + 1, B, "decode"), base.ShapeSuite("d", S + 1, B, "decode")
    jstep, jp_sh, jtok_sh, jc_sh, _ = jserve.jit_decode_step(jmodel, _jmesh(), jdsuite, variant=variant)
    want, _ = _strict(jstep, jax.device_put(jparams, jp_sh),
                      jax.device_put({k: jnp.asarray(v) for k, v in inputs.items()}, jtok_sh),
                      jax.device_put(jcache, jc_sh))
    step, p_sh, tok_sh, c_sh, _ = serve.jit_decode_step(model, one_rank, dsuite, variant=variant)
    tcache = dist.distribute(from_jax_params(jcache, "cpu"), c_sh)
    got, cache2 = step(dist.distribute(params, p_sh), dist.distribute(from_jax_params(inputs, "cpu"), tok_sh), tcache)
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err < TOL_LOGITS, ("decode logits", err)
    # written in place, the twin of donation: the caller's cache holds what
    # the step returns (zamba2's K/V come back in the cache plan's layout,
    # redistributed from the reference's batch-sharded one)
    assert all(torch.equal(dist.full(cache2[n]), dist.full(tcache[n])) for n in tcache)
    if "k" in tcache:
        assert cache2["k"] is tcache["k"]


def _prompt_len(cfg) -> int:
    """31 tokens; a recurrent family's prompt is three of its chunks, since
    the plain scans (the reference's and the port's) assert that the chunk
    divides the sequence."""
    return S_PROMPT if cfg.ssm is None else 3 * cfg.ssm.chunk


def _cache_err(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """The largest error of a cache leaf; a recurrent state's relative to its
    largest element (at least 1), as ``torch_mesh_family.py`` reads it."""
    err = float(np.max(np.abs(got - want)))
    return err / max(1.0, float(np.max(np.abs(want)))) if name in RECURRENT_CACHES else err


def test_two_moe_archs_of_other_top_k_on_one_layout_in_one_process(one_rank):
    """DTensor caches each op's output sharding under a key that leaves
    ``topk``'s k out. The router's top-k runs on local shards
    (``dist.topk_last``), so the second arch, routing the same layout with
    another k, reads no stale shape: deepseek's top 6 and then olmoe's top 8
    (their full configs' k) on the reduced configs' 8 experts."""
    psuite = base.ShapeSuite("p", S_PROMPT, B, "prefill")
    for arch in ("deepseek-moe-16b", "olmoe-1b-7b"):
        cfg = CONFIGS[arch].reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=CONFIGS[arch].moe.top_k))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        prompt = from_jax_params(synthetic.batch_for(cfg, psuite, seed=0), "cpu")
        prompt.pop("labels", None)
        with torch.no_grad():
            want, _ = model.prefill(params, prompt, make_plan(cfg, None))
        step, p_sh, b_sh, _ = serve.jit_prefill_step(model, one_rank, psuite)
        got, _ = step(dist.distribute(params, p_sh), dist.distribute(prompt, b_sh))
        assert tuple(got.shape) == tuple(want.shape)
        err = float(np.max(np.abs(_np(got) - _np(want))))
        assert err < TOL_LOGITS, (arch, cfg.moe.top_k, err)


def test_topk_of_a_dtensor_takes_each_calls_k(one_rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    probs = torch.rand(16, 8, generator=torch.Generator().manual_seed(0)).softmax(-1)
    x = distribute_tensor(probs, one_rank, [Shard(0), Replicate()])
    for k in (6, 8, 3):
        vals, idx = dist.topk_last(x, k)
        want_vals, want_idx = torch.topk(probs, k, dim=-1)
        assert tuple(vals.shape) == tuple(idx.shape) == (16, k) and vals.placements == x.placements
        assert torch.equal(vals.full_tensor(), want_vals) and torch.equal(idx.full_tensor(), want_idx)
