"""``repro_torch.convert.from_jax_params``: the reference's parameter tree to
the port's, leaf by leaf, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.model_api import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.model_api import build_model

ARCHS = ["granite-3-2b", "qwen2-72b", "stablelm-12b", "llava-next-34b", "resnet_small"]


def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, (dict, list)):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_keeps_every_leaf(arch):
    jparams = jax_build_model(jax_get_config(arch).reduced()).init(jax.random.key(0))
    host = jax.device_get(jparams)
    params = from_jax_params(host, "cpu")
    want, got = _flatten(host), _flatten(params)
    assert set(got) == set(want)
    for path, leaf in want.items():
        t = got[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == leaf.dtype.name, path
        # bit-equal: every bf16 is a float32, so the round trip through f32 is exact
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, dtype=np.float32), err_msg=path)
    if arch == "qwen2-72b":
        assert "layers/attn/bq" in got
    if arch == "resnet_small":  # a list of blocks, HWIO conv weights, all f32
        assert isinstance(params["blocks"], list) and got["blocks/0/conv2/w"].shape[:2] == (3, 3)
        assert all(t.dtype == torch.float32 for t in got.values())
        return
    # norm scales stay f32, matrices stay bf16
    assert got["final_norm/scale"].dtype == torch.float32
    assert got["layers/attn/wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(arch):
    """The port's own init builds the same tree, shapes and types."""
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    want = _flatten(jax.eval_shape(jmodel.init, jax.random.key(0)))
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    got = _flatten(params)
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path].shape) == spec.shape, path
        assert str(got[path].dtype).replace("torch.", "") == spec.dtype.name, path
    assert model.param_count() == model.param_count(params) == jmodel.param_count()
    # seeded: the same generator state gives the same weights
    again = _flatten(model.init(torch.Generator().manual_seed(0), "cpu"))
    assert all(torch.equal(got[p], again[p]) for p in got)


def test_bf16_special_values_survive():
    vals = np.array([0.0, -0.0, 1.0, -1.5, 3.3895314e38, 1e-40, np.inf], dtype=np.float32)
    leaf = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    t = from_jax_params({"x": leaf}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), leaf.view(np.int16))


def test_default_device_is_the_gpu_and_never_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"x": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("granite-3-2b").reduced()).init(torch.Generator())
