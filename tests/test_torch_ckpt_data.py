"""The port's checkpoint store and host pipeline: twins of
tests/test_checkpoint.py and of the pipeline tests of tests/test_data.py, a
bfloat16 round trip with ``ml_dtypes`` absent, and checkpoints moving between
the two packages bit for bit.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint.store import MANIFEST, CheckpointStore
from repro_torch.data import synthetic
from repro_torch.data.pipeline import HostPipeline
from repro_torch.optim.adamw import AdamWState

REPO = Path(__file__).resolve().parent.parent


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((8, 16), generator=g),
            "emb": torch.randn((32, 8), generator=g).to(torch.bfloat16),
        },
        "opt": {
            "step": torch.tensor(7, dtype=torch.int32),
            "m": torch.randn((8, 16), generator=g),
        },
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif hasattr(tree, "_fields"):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def assert_tree_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip_including_bf16(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = make_tree()
    store.save(10, tree, extra={"loss": 1.5})
    restored, extra = store.restore(tree)
    assert_tree_equal(tree, restored)
    assert list(restored["params"]) == list(tree["params"])  # the caller's key order
    assert extra == {"loss": 1.5}
    assert store.latest_step() == 10


def test_manifestless_checkpoint_is_invisible(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = make_tree()
    store.save(1, tree)
    store.save(2, tree)
    (tmp_path / "step_00000002" / MANIFEST).unlink()  # simulate torn write
    assert store.latest_step() == 1
    restored, _ = store.restore(tree)
    assert_tree_equal(tree, restored)


def test_crc_corruption_detected(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    path = store.save(3, tree)
    f = next(p for p in path.iterdir() if p.name.endswith(".npy"))
    raw = bytearray(f.read_bytes())
    raw[-4] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        store.restore(tree)


def test_gc_keeps_last_k(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        store.save(s, tree)
    assert [c.step for c in store.list()] == [3, 4]


def test_async_save_joins_and_is_valid(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = make_tree(1)
    store.save(5, tree, async_save=True)
    store.wait()
    restored, _ = store.restore(tree)
    assert_tree_equal(tree, restored)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_async_save_snapshot_semantics(tmp_path, kind):
    """The async save must capture values at call time, not at write time:
    the train loop updates its state in place right after."""
    store = CheckpointStore(tmp_path)
    w = np.arange(8, dtype=np.float32) if kind == "numpy" else torch.arange(8, dtype=torch.float32)
    store.save(6, {"w": w}, async_save=True)
    w[:] = -1  # caller mutates immediately after
    store.wait()
    restored, _ = store.restore({"w": torch.zeros(8)})
    assert torch.equal(restored["w"], torch.arange(8, dtype=torch.float32))


def test_restore_specific_step(tmp_path):
    store = CheckpointStore(tmp_path)
    for s in (1, 2):
        store.save(s, {"w": torch.full((4,), float(s))})
    restored, _ = store.restore({"w": torch.zeros(4)}, step=1)
    assert torch.equal(restored["w"], torch.ones(4))


def test_leaf_keys_follow_the_reference(tmp_path):
    store = CheckpointStore(tmp_path)
    state = {"params": {"b": torch.zeros(2), "a": {"w": torch.zeros(3)}},
             "opt": AdamWState(torch.tensor(0, dtype=torch.int32), {"w": torch.zeros(1)}, {"w": torch.zeros(1)})}
    path = store.save(1, state)
    files = sorted(p.name for p in path.iterdir())
    assert files == sorted(["manifest.json", "opt__m__w.npy", "opt__step.npy", "opt__v__w.npy",
                            "params__a__w.npy", "params__b.npy"])


# ---------------------------------------------------------------------------
# between the two packages, and without ml_dtypes
# ---------------------------------------------------------------------------


def _jax_state():
    k = jax.random.split(jax.random.key(3), 4)
    return {
        "params": {"emb": jax.random.normal(k[0], (32, 8)).astype(jnp.bfloat16),
                   "norm": {"scale": jax.random.normal(k[1], (8,))}},
        "opt": JAdamWState(step=jnp.int32(11), m={"emb": jax.random.normal(k[2], (32, 8)),
                                                   "norm": {"scale": jnp.zeros((8,))}},
                           v={"emb": jax.random.normal(k[3], (32, 8)) ** 2, "norm": {"scale": jnp.ones((8,))}}),
    }


def _torch_like():
    return {
        "params": {"emb": torch.zeros(32, 8, dtype=torch.bfloat16), "norm": {"scale": torch.zeros(8)}},
        "opt": AdamWState(torch.tensor(0, dtype=torch.int32), {"emb": torch.zeros(32, 8), "norm": {"scale": torch.zeros(8)}},
                          {"emb": torch.zeros(32, 8), "norm": {"scale": torch.zeros(8)}}),
    }


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_reference_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    jstate = _jax_state()
    JStore(tmp_path).save(4, jstate, extra={"loss": 2.0})
    got, extra = CheckpointStore(tmp_path).restore(_torch_like())
    assert extra == {"loss": 2.0} and isinstance(got["opt"], AdamWState)
    assert got["params"]["emb"].dtype == torch.bfloat16 and got["opt"].step.dtype == torch.int32
    for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert _bits(a) == _bits(b)


def test_port_checkpoint_restores_into_the_reference_bit_for_bit(tmp_path):
    jstate = _jax_state()
    JStore(tmp_path / "j").save(1, jstate)
    tstate, _ = CheckpointStore(tmp_path / "j").restore(_torch_like())
    CheckpointStore(tmp_path / "t").save(9, tstate)
    back, _ = JStore(tmp_path / "t").restore(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    # the same types, shapes and crc32s in the two manifests
    man = {p: json.loads((tmp_path / p / f"step_0000000{s}" / MANIFEST).read_text()) for p, s in (("j", 1), ("t", 9))}
    crcs = {p: {m["key"]: (m["dtype"], m["shape"], m["shards"][0]["crc32"]) for m in man[p]["leaves"]} for p in man}
    assert crcs["j"] == crcs["t"]


_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None  # `import ml_dtypes` now raises ImportError
import torch
from repro_torch.checkpoint.store import CheckpointStore
t = {"w": (torch.arange(24, dtype=torch.float32) / 7).reshape(4, 6).to(torch.bfloat16)}
store = CheckpointStore(sys.argv[1])
store.save(2, t)
back, _ = store.restore({"w": torch.zeros(4, 6, dtype=torch.bfloat16)})
assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16), t["w"].view(torch.int16))
print("BF16-WITHOUT-ML-DTYPES")
"""


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BF16-WITHOUT-ML-DTYPES" in proc.stdout
    # and the reference reads what was written there
    back, _ = JStore(tmp_path).restore({"w": jnp.zeros((4, 6), jnp.bfloat16)})
    want = (np.arange(24, dtype=np.float32) / 7).reshape(4, 6)
    np.testing.assert_array_equal(np.asarray(back["w"].astype(jnp.float32)),
                                  torch.from_numpy(want).to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# twins of the pipeline tests of tests/test_data.py
# ---------------------------------------------------------------------------


def _counter_source(step):
    return {"x": np.full((4,), step, dtype=np.int64)}


def test_pipeline_is_deterministically_ordered_with_many_workers():
    with HostPipeline(_counter_source, workers=4, max_queue_size=4) as p:
        got = [int(p.get()["x"][0]) for _ in range(40)]
    assert got == list(range(40))


def test_pipeline_start_step_resume():
    with HostPipeline(_counter_source, workers=2, max_queue_size=3, start_step=17) as p:
        got = [int(p.get()["x"][0]) for _ in range(5)]
    assert got == [17, 18, 19, 20, 21]


def test_pipeline_hides_slow_source():
    def slow(step):
        time.sleep(0.02)
        return {"x": np.full((1,), step)}

    with HostPipeline(slow, workers=8, max_queue_size=16) as p:
        p.get()  # warmup
        t0 = time.perf_counter()
        for _ in range(20):
            p.get()
        elapsed = time.perf_counter() - t0
    assert elapsed < 0.2, f"pipeline failed to hide latency: {elapsed:.3f}s"


def test_queue_bytes_accounting_and_stats():
    b = synthetic.image_batch(synthetic.CIFAR10, 8, seed=0)
    per = b["images"].nbytes + b["labels"].nbytes
    assert HostPipeline.queue_bytes(b, 10) == 10 * per
    with HostPipeline(_counter_source, workers=1, max_queue_size=2) as p:
        p.get()
        stats = p.stats()
    assert stats["batches"] == 1.0 and stats["workers"] == 1.0 and stats["max_queue_size"] == 2.0
    assert set(stats) == {"batches", "input_wait_s", "input_wait_per_batch_ms", "workers", "max_queue_size"}
