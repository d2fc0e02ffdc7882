"""The port's multi-device substrate against the JAX reference, in this
process.

* Spec parity: for every registry arch, on meshes (2, 4), (16, 16) and
  (2, 16, 16), the port's spec rules (``make_plan``'s ``act_specs`` per
  variant and suite, ``param_pspecs`` + ``validate_pspecs``,
  ``serve_param_pspecs``, ``zero_param_pspecs``) equal the reference's, run
  on ``jax.sharding.AbstractMesh``: no device, no process group.
* On a 1 x 1 mesh (a one-rank gloo group over a ``FileStore`` in
  ``tmp_path``): the port's ``jit_train_step`` against the reference's, two
  steps from converted weights, loss to 3e-2 (tests/test_variants.py's
  tolerance), for baseline, sp and zero; ``jit_decode_step`` against the
  reference's at 6e-2 for baseline and serve.

The multi-rank semantics are held by ``test_torch_mesh_ranks.py`` (gloo,
subprocesses): the reference's own multi-device tests are red on this tree,
so the port's sharded path is held there to the port's single-device path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import AbstractMesh, Mesh

from repro.configs import base as jbase
from repro.configs.registry import CONFIGS as JCONFIGS
from repro.models.model_api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.runtime import serve_step as jserve
from repro.runtime import train_step as jts
from repro.sharding import plan as jplan
from repro_torch.configs import base
from repro_torch.configs.registry import CONFIGS
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_mesh_shape, mesh_chips, mesh_label
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_paths
from repro_torch.optim import adamw
from repro_torch.runtime import serve_step as serve
from repro_torch.runtime import train_step as ts
from repro_torch.sharding import dist
from repro_torch.sharding import plan as tplan

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
VARIANTS = ("baseline", "sp", "zero", "serve")
#: the suites make_plan reads: a divisible batch, a batch of 1 (the sequence
#: takes every axis), decode (seq 1 steps), and none
SUITES = ("train_4k", "prefill_32k", "decode_32k", "long_500k", None)


def _suite(name, pkg):
    return None if name is None else next(s for s in pkg.ALL_SHAPES if s.name == name)


def _jax_flat(tree):
    """{"a/b/c": leaf} of a jax pytree of dicts and lists, specs as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, leaf in flat:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def _port_flat(tree):
    """{"a/b/c": spec} of a port spec tree (a ``P`` is a leaf)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            out["/".join(prefix)] = node

    walk(tree, ())
    return out


def _same(port_specs, ref_specs):
    """Leaf by leaf, the port's spec is the reference's, entry for entry."""
    got, want = _port_flat(port_specs), _jax_flat(ref_specs)
    assert set(got) == set(want)
    for path in want:
        assert isinstance(got[path], tplan.P), path
        assert tuple(got[path]) == tuple(want[path]), (path, got[path], want[path])


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (the reference's eval_shape params, the port's meta params)."""
    out = {}
    for arch in CONFIGS:
        jshape = jax.eval_shape(jbuild_model(JCONFIGS[arch]).init, jax.random.key(0))
        out[arch] = (jshape, ts.param_shapes(build_model(CONFIGS[arch])))
    return out


@pytest.mark.parametrize("mesh_def", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_spec_rules_equal_the_reference(arch, mesh_def, shapes):
    sizes, axes = mesh_def
    jmesh, mesh = AbstractMesh(sizes, axes), tplan.AbstractMesh(sizes, axes)
    jshape, shape = shapes[arch]
    assert sorted("/".join(p) for p, _ in tree_paths(shape)) == sorted(_jax_flat(jshape))
    for variant in VARIANTS:
        for sname in SUITES:
            want = jplan.make_plan(JCONFIGS[arch], jmesh, _suite(sname, jbase), variant=variant)
            got = tplan.make_plan(CONFIGS[arch], mesh, _suite(sname, base), variant=variant)
            assert (got.dp_axes, got.tp_axis) == (want.dp_axes, want.tp_axis), (variant, sname)
            assert set(got.act_specs) == set(want.act_specs)
            for kind, spec in want.act_specs.items():
                assert tuple(got.act_specs[kind]) == tuple(spec), (variant, sname, kind)
                assert tuple(got.spec(kind)) == tuple(want.spec(kind))
    _same(tplan.validate_pspecs(shape, tplan.param_pspecs(shape), mesh),
          jplan.validate_pspecs(jshape, jplan.param_pspecs(jshape), jmesh))
    _same(tplan.param_pspecs(shape), jplan.param_pspecs(jshape))
    _same(tplan.serve_param_pspecs(shape, mesh), jplan.serve_param_pspecs(jshape, jmesh))
    _same(tplan.zero_param_pspecs(shape, mesh), jplan.zero_param_pspecs(jshape, jmesh))


def test_partition_spec_twin_normalizes_as_the_reference():
    P, JP = tplan.P, jax.sharding.PartitionSpec
    for entries in [(), (None,), (("data",), None), ((), None), (("pod", "data"), None, "model")]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P() != P(None)


def test_null_plan_and_no_mesh():
    cfg = CONFIGS["granite-3-2b"]
    plan = tplan.make_plan(cfg, None)
    x = torch.ones(2, 3)
    assert plan.act(x, "hidden") is x and plan.sharding("hidden") is None
    assert tuple(plan.spec("hidden")) == ()


def test_families_without_sharded_activations_raise_with_their_roadmap_item(one_rank):
    """No family raises the sharded path's refusal any more: the hybrid, rwkv
    and resnet families build the train step under every variant and the
    serve steps under every serving variant; ResNet's serve steps, called,
    raise the model's own error, as the reference's do. (The steps run in
    the 2 x 4 family files and ``test_torch_mesh_reference.py``.)"""
    suite = base.ShapeSuite("t", 32, 8, "train")
    psuite, dsuite = base.ShapeSuite("p", 32, 8, "prefill"), base.ShapeSuite("d", 33, 8, "decode")
    opt = adamw.AdamWConfig()
    for arch in ("zamba2-7b", "rwkv6-1.6b", "resnet_small"):
        model = build_model(CONFIGS[arch].reduced())
        for variant in ("baseline", "sp", "zero"):
            step, _, _, plan = ts.jit_train_step(model, one_rank, suite, opt, variant=variant)
            assert callable(step) and plan.mesh is one_rank
        for variant in ("baseline", "serve", "zero"):
            prefill, *_ = serve.jit_prefill_step(model, one_rank, psuite, variant=variant)
            decode, *_ = serve.jit_decode_step(model, one_rank, dsuite, variant=variant)
            if arch == "resnet_small":
                for step, args in ((prefill, ({}, {})), (decode, ({}, {}, {}))):
                    with pytest.raises(NotImplementedError, match="CNN classifier has no autoregressive serving path"):
                        step(*args)


def test_jit_train_step_refuses_to_keep_the_callers_state():
    # the step updates the state in place: the reference's donate=False has no twin
    model = build_model(CONFIGS["granite-3-2b"].reduced())
    with pytest.raises(NotImplementedError, match="donate=False"):
        ts.jit_train_step(model, tplan.AbstractMesh((2, 4), ("data", "model")), base.ShapeSuite("t", 32, 8, "train"),
                          adamw.AdamWConfig(), donate=False)


def test_a_mesh_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh_shape((1, 1), ("data", "model"))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh2:  # what ``placements`` reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

    P = tplan.P
    assert tplan.placements(Mesh2, P(None, "model")) == [Replicate(), Replicate(), Shard(1)]
    assert tplan.placements(Mesh2, P(("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert tplan.placements(Mesh2, P()) == [Replicate()] * 3


# ---------------------------------------------------------------------------
# a 1 x 1 mesh in this process, against the reference's jitted steps
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (FileStore in tmp_path: no port) and its 1 x 1 mesh."""
    tdist.init_process_group("gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh_shape((1, 1), ("data", "model"), device="cpu")
    finally:
        tdist.destroy_process_group()


def test_mesh_helpers(one_rank):
    from torch.distributed.tensor import Replicate, Shard

    assert mesh_chips(one_rank) == 1 and mesh_label(one_rank) == "1x1"
    assert tplan.mesh_shape(one_rank).shape == {"data": 1, "model": 1}
    P = tplan.P
    tree = {"a": torch.zeros(4, 6), "b": [torch.zeros(3)]}
    sh = tplan.named_shardings(tree, {"a": P("data", "model"), "b": [P()]}, one_rank)
    assert sh["a"].placements == [Shard(0), Shard(1)] and sh["b"][0].placements == [Replicate(), Replicate()]
    put = dist.distribute(tree, sh)
    assert put["a"].placements == (Shard(0), Shard(1)) and put["b"][0].shape == (3,)


@pytest.mark.parametrize("variant", ["baseline", "sp", "zero"])
def test_jit_train_step_on_one_device_mesh_matches_the_reference(variant, one_rank):
    jcfg, cfg = JCONFIGS["granite-3-2b"].reduced(), CONFIGS["granite-3-2b"].reduced()
    jsuite, suite = jbase.ShapeSuite("t", 32, 8, "train"), base.ShapeSuite("t", 32, 8, "train")
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jopt = jadamw.AdamWConfig(warmup_steps=1, total_steps=10)
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    batch = synthetic.batch_for(cfg, suite, seed=0)

    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep, jst_sh, jb_sh, _ = jts.jit_train_step(jmodel, jmesh, jsuite, jopt, variant=variant)
    jstate0 = jts.init_train_state(jmodel, jax.random.key(0), jopt)
    state0 = from_jax_train_state(jax.device_get(jstate0), "cpu")
    jstate = jax.device_put(jstate0, jst_sh)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jb_sh)

    step, st_sh, b_sh, plan = ts.jit_train_step(model, one_rank, suite, opt, variant=variant)
    state = dist.distribute(state0, st_sh)
    b = dist.distribute({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, b_sh)
    assert all(dist.is_dtensor(p) for p in state["opt"].m["layers"]["attn"].values())
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        assert abs(float(m["loss"]) - float(jm["loss"])) < 3e-2, (variant, float(m["loss"]), float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) < 3e-2 * float(jm["grad_norm"])


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_jit_decode_step_on_one_device_mesh_matches_the_reference(variant, one_rank):
    jcfg, cfg = JCONFIGS["granite-3-2b"].reduced(), CONFIGS["granite-3-2b"].reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = from_jax_params(jax.device_get(jparams), "cpu")
    B, S = 8, 31
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    last, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jplan.make_plan(jcfg, None))
    jcache = jax.device_get(jserve.pad_cache(jcache, 1))  # on the host: the jitted step donates its copy
    tok = np.array(jnp.argmax(last, -1).astype(jnp.int32))  # a writable copy

    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep, jp_sh, jtok_sh, jc_sh, _ = jserve.jit_decode_step(jmodel, jmesh, jbase.ShapeSuite("d", 32, 8, "decode"),
                                                             variant=variant)
    want, _ = jstep(jax.device_put(jparams, jp_sh), jax.device_put({"token": jnp.asarray(tok)}, jtok_sh),
                    jax.device_put(jcache, jc_sh))

    step, p_sh, tok_sh, c_sh, plan = serve.jit_decode_step(model, one_rank, base.ShapeSuite("d", 32, 8, "decode"),
                                                           variant=variant)
    cache = dist.distribute(from_jax_params(jcache, "cpu"), c_sh)
    got, cache2 = step(dist.distribute(params, p_sh), dist.distribute({"token": torch.from_numpy(tok)}, tok_sh), cache)
    err = float(np.max(np.abs(got.full_tensor().float().numpy() - np.asarray(want, np.float32))))
    assert err < 6e-2, err
    assert cache2["k"] is cache["k"]  # written in place, the twin of donation
