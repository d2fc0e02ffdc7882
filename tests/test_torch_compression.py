"""EF-int8 gradient compression of the port against the reference.

* On one rank (a one-rank gloo group over a ``FileStore`` in ``tmp_path``)
  against the reference's ``ef_int8_psum`` on a (1,) mesh: the mean and the
  new error, bit for bit, over three rounds of error feedback;
  ``compression_wire_bytes`` and ``uncompressed_psum`` as the reference's.
* At world 4 (gloo, one process a rank, spawned by this file run as a
  script): the error-feedback identity, dequantized mean + residual = this
  rank's share of the exact mean plus its input error (1e-6), the scale
  shared by MAX, the residual within half a quantization step, and the mean
  within a step of the uncompressed one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.optim import compression  # noqa: E402


@pytest.fixture
def one_rank(tmp_path):
    tdist.init_process_group("gloo", store=tdist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 33)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal((7,)) * 3.0).astype(np.float32)}


def test_ef_int8_psum_matches_the_reference_bit_for_bit(one_rank):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.optim import compression as jcompression
    from repro.runtime.compat import shard_map

    mesh = jax.make_mesh((1,), ("pod",))
    body = shard_map(lambda g, e: jcompression.ef_int8_psum(g, e, "pod"), mesh=mesh, in_specs=(P(), P()),
                     out_specs=(P(), P()), check_vma=False)
    jerr = jcompression.init_error_state({k: jnp.asarray(v) for k, v in _grads(0).items()})
    err = compression.init_error_state({k: torch.from_numpy(v) for k, v in _grads(0).items()})
    for round_ in range(3):
        g = _grads(round_)
        jmean, jerr = body({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        mean, err = compression.ef_int8_psum({k: torch.from_numpy(v) for k, v in g.items()}, err)
        for k in g:
            np.testing.assert_array_equal(mean[k].numpy(), np.asarray(jmean[k]), err_msg=f"mean {k} round {round_}")
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]), err_msg=f"err {k} round {round_}")
    unc = compression.uncompressed_psum({k: torch.from_numpy(v) for k, v in _grads(5).items()})
    for k, v in _grads(5).items():
        np.testing.assert_array_equal(unc[k].numpy(), v)


def test_compression_wire_bytes_match_the_reference():
    import jax.numpy as jnp

    from repro.optim import compression as jcompression

    for shapes in ([(256,)], [(64, 33), (7,)], [(3, 4, 5), (1,), (1000,)]):
        jtree = {f"l{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
        tree = {f"l{i}": torch.zeros(s) for i, s in enumerate(shapes)}
        assert compression.compression_wire_bytes(tree) == jcompression.compression_wire_bytes(jtree)


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                             world_size=world)
    try:
        gens = [_grads(10 + r) for r in range(world)]
        mine = {k: torch.from_numpy(v * (rank + 1)) for k, v in gens[rank].items()}
        e0 = {k: torch.from_numpy(np.full(v.shape, 1e-3 * rank, np.float32)) for k, v in gens[rank].items()}
        mean, err = compression.ef_int8_psum(mine, e0)
        exact = compression.uncompressed_psum({k: v + e0[k] for k, v in mine.items()})
        out = {}
        for k in mine:
            gf = mine[k] + e0[k]
            scale = torch.tensor(max(float((torch.from_numpy(gens[r][k] * (r + 1)) + 1e-3 * r).abs().max())
                                     for r in range(world)) / 127.0 + 1e-12)
            q = torch.round(gf / scale)
            out[k] = {
                # EF identity: what this rank sent (q * scale) + what it keeps (err) = its input
                "identity": float((q * scale + err[k] - gf).abs().max()),
                "residual_over_half_step": float(err[k].abs().max() / (0.5 * scale)),
                "mean_vs_exact_in_steps": float((mean[k] - exact[k]).abs().max() / scale),
            }
        gathered = [None] * world
        tdist.all_gather_object(gathered, out)
        if rank == 0:
            Path(tmp, "result.json").write_text(json.dumps(gathered))
    finally:
        tdist.destroy_process_group()


def test_error_feedback_identity_at_world_4(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, __file__, "4", str(tmp_path)], capture_output=True, text=True, timeout=180,
                         env=env)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    for rank, r in enumerate(json.loads((tmp_path / "result.json").read_text())):
        for k, v in r.items():
            assert v["identity"] <= 1e-6, (rank, k, v)
            assert v["residual_over_half_step"] <= 1.0 + 1e-5, (rank, k, v)
            assert v["mean_vs_exact_in_steps"] <= 0.5 + 1e-5, (rank, k, v)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    world, tmp = int(sys.argv[1]), sys.argv[2]
    mp.spawn(_rank_main, args=(world, tmp), nprocs=world, join=True)
