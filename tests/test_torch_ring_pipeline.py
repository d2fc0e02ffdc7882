"""Ring collective-matmuls and the GPipe pipeline of the port on the CPU:
gloo process groups, one process a rank, against their oracles (the twin of
tests/test_pipeline_ring.py).

* ``ring_ag_matmul`` and ``ring_rs_matmul`` at world 4 and world 1 (a ring
  of one exchanges nothing) against the all-gather oracle ``x @ W``;
* ``pipeline_forward`` at 2 and 3 stages (4 and 3 microbatches) against the
  plain forward of the same reduced granite-3-2b, at 6e-2.

Each world runs this file as a script in a subprocess that spawns its ranks
over a ``FileStore`` in a temporary directory (no TCP port); rank 0 writes
JSON.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

TIMEOUT_S = 180


def run_ranks(case: str, world: int, tmp: Path) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, __file__, case, str(world), str(tmp)], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=env)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads((tmp / "result.json").read_text())


def case_ring(rank: int, world: int) -> dict:
    from repro_torch.runtime.ring import ring_ag_matmul, ring_rs_matmul

    rng = np.random.default_rng(0)
    B, d, f = 8, 16, 32  # f_local = f // world
    x = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, f)).astype(np.float32))
    x2 = torch.from_numpy(rng.standard_normal((B, f)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((f, d)).astype(np.float32))
    bl, fl = B // world, f // world
    rows, cols = slice(rank * bl, (rank + 1) * bl), slice(rank * fl, (rank + 1) * fl)
    ag = ring_ag_matmul(x[rows], w[:, cols])
    rs = ring_rs_matmul(x2[rows], w2[cols])
    return {"ag_shape": list(ag.shape), "rs_shape": list(rs.shape),
            "ag_err": float((ag - (x @ w)[rows]).abs().max()), "rs_err": float((rs - (x2 @ w2)[rows]).abs().max())}


def case_pipeline(rank: int, world: int) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_api import build_model
    from repro_torch.runtime.pipeline import pipeline_forward
    from repro_torch.sharding.plan import make_plan

    cfg = get_config("granite-3-2b").reduced(n_layers=6)  # 3 or 2 layers a stage
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    M, mb, S = world + 1, 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (M, mb, S)).astype(np.int32))
    logits = pipeline_forward(cfg, params, toks, make_mesh_shape((world,), ("stage",), device="cpu"))
    with torch.no_grad():
        want = tfm.forward(cfg, params, toks.reshape(M * mb, S), make_plan(cfg, None)).float()
    return {"shape": list(logits.shape), "err": float((logits - want.reshape(logits.shape)).abs().max())}


CASES = {"ring": case_ring, "pipeline": case_pipeline}


def _rank_main(rank: int, case: str, world: int, tmp: str) -> None:
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                             world_size=world)
    try:
        result = CASES[case](rank, world)
        gathered = [None] * world
        tdist.all_gather_object(gathered, result)
        if rank == 0:
            Path(tmp, "result.json").write_text(json.dumps(gathered))
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("world", [4, 1])
def test_ring_matmuls_match_the_all_gather_oracle(world, tmp_path):
    for rank, r in enumerate(run_ranks("ring", world, tmp_path)):
        assert r["ag_shape"] == [8 // world, 32] and r["rs_shape"] == [8 // world, 16], r
        assert r["ag_err"] < 1e-4 and r["rs_err"] < 1e-4, (rank, r)


@pytest.mark.parametrize("stages", [2, 3])
def test_gpipe_pipeline_matches_plain_forward(stages, tmp_path):
    results = run_ranks("pipeline", stages, tmp_path)
    for r in results:  # every rank holds the last stage's logits
        assert r["shape"][:3] == [stages + 1, 2, 16], r
        assert r["err"] < 6e-2, r
    assert len({json.dumps(r) for r in results}) == 1


if __name__ == "__main__":
    import torch.multiprocessing as mp

    case, world, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank_main, args=(case, world, tmp), nprocs=world, join=True)
