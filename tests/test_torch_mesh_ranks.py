"""The port's sharded steps at several ranks on the CPU: gloo process groups,
one process a rank, against the port's own single-device path.

Each check runs this file as a script in a subprocess, which spawns the
ranks (``torch.multiprocessing``) over a ``FileStore`` in a temporary
directory, so no TCP port is taken; rank 0 writes what it found as JSON.
The reference's own multi-device tests are red on this tree, so the port's
multi-rank path is held to its single-device path at the reference's
tolerances (tests/test_variants.py: loss 3e-2, decode logits 6e-2):

  * on a 2 x 4 (data, model) mesh, ``jit_train_step`` for baseline, sp and
    zero (granite-3-2b reduced, remat on as at full size), baseline for stablelm-12b reduced, and zero
    for one arch of every other family, two steps each against
    ``build_train_step`` on the same batch: the losses, the gradient norms
    and AdamW's first moment after the first step; ``adamw.global_norm`` and
    ``apply_updates`` on sharded and replicated DTensor leaves against the
    same on whole tensors;
  * ``jit_decode_step`` (baseline, serve, zero) and ``jit_prefill_step``
    (baseline, zero) against the single-device decode and prefill, and the
    decode's new K/V slot written in place into the sharded cache;
  * ``python -m repro_torch.launch.train --mesh host`` under ``torchrun`` at 4
    ranks against ``--mesh none``.
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

#: zero for one arch of each family but the dense one (granite covers it)
ZERO_ARCHS = ("olmoe-1b-7b", "zamba2-7b", "rwkv6-1.6b", "whisper-base", "llava-next-34b", "resnet_small")
MESH = (2, 4)
#: the first step, on the same weights on both paths: its gradient norm, and
#: the relative L2 error of each leaf of AdamW's first moment after it (0.1
#: times the clipped gradient). Read: at most 2.6e-4 and 1.5e-2
#: (bf16 compute); a planted fault in a reduction gives errors of order 1.
STEP1_GRAD_NORM_RTOL, STEP1_MOMENT_RTOL = 1e-3, 3e-2
#: the second step's gradient norm, after a first update in which AdamW turns
#: rounding noise in gradients near zero into whole steps (read: at most 7e-3,
#: resnet_small's BatchNorm)
STEP2_GRAD_NORM_RTOL = 2e-2
TIMEOUT_S = 300


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_ranks(case: str, shape, tmp: Path) -> dict:
    """Runs ``case`` on a mesh of ``shape`` (one process a rank); rank 0's result."""
    out = subprocess.run([sys.executable, __file__, case, "x".join(map(str, shape)), str(tmp)],
                         capture_output=True, text=True, timeout=TIMEOUT_S, env=_env())
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads((tmp / "result.json").read_text())


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _batch(cfg, suite):
    from repro_torch.convert import from_jax_params  # numpy leaves, bfloat16 ones included
    from repro_torch.data import synthetic

    return from_jax_params(synthetic.batch_for(cfg, suite, seed=0), "cpu")


def _two_steps(step, state, batch):
    """Two steps: the losses, the gradient norms, and AdamW's first moment
    after each step, whole. The moment is f32 and holds the clipped gradient
    the reductions across ranks made, which the bf16 weights would round away."""
    from repro_torch.models.module import tree_leaves
    from repro_torch.sharding import dist

    res, moments = {"loss": [], "grad_norm": []}, []
    for _ in range(2):
        state, m = step(state, batch)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        moments.append([dist.full(mu).detach().float().clone() for mu in tree_leaves(state["opt"].m)])
    return res, moments


def _rel_l2(got, want) -> float:
    """The largest relative L2 error over the leaves; a leaf that is zero on
    the single device must be zero here too."""
    errs = []
    for g, w in zip(got, want):
        ref, diff = float(w.norm()), float((g - w).norm())
        errs.append(diff / ref if ref > 0 else diff)
    return max(errs)


def case_train(mesh) -> dict:
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_api import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding import dist
    from repro_torch.sharding.plan import make_plan

    # no warmup: both steps move the weights at the peak rate, so the second
    # step's loss and gradient read the first step's update
    opt = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    out = {}

    def single_and(arch, variants, **overrides):
        cfg = get_config(arch).reduced(**overrides)
        model = build_model(cfg)
        suite = ShapeSuite("t", 32 if cfg.family != "resnet" else cfg.img_size**2, 8, "train")
        batch = _batch(cfg, suite)
        init = lambda: ts.init_train_state(model, torch.Generator().manual_seed(0), opt, "cpu")  # noqa: E731
        res, want = _two_steps(ts.build_train_step(model, make_plan(cfg, None), opt), init(), batch)
        found = {"single": res}
        for variant in variants:
            step, st_sh, b_sh, _ = ts.jit_train_step(model, mesh, suite, opt, variant=variant)
            res, got = _two_steps(step, dist.distribute(init(), st_sh), dist.distribute(batch, b_sh))
            found[variant] = dict(res, moment_err=[_rel_l2(g, w) for g, w in zip(got, want)])
        return found

    out["granite-3-2b"] = single_and("granite-3-2b", ("baseline", "sp", "zero"), remat=True)  # as at full size
    out["stablelm-12b"] = single_and("stablelm-12b", ("baseline",))
    for arch in ZERO_ARCHS:
        out[arch] = single_and(arch, ("zero",))
    out["norm"] = _norm_and_update(mesh)
    return out


def _norm_and_update(mesh) -> dict:
    """AdamW on a tree of one sharded, one partly replicated and one wholly
    replicated DTensor leaf, against the same on whole tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(3)
    whole = {"w": torch.randn(8, 12, generator=gen), "b": torch.randn(12, generator=gen),
             "scale": torch.randn(4, 6, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) * 3 for k, v in whole.items()}
    placements = {"w": [Shard(0), Shard(1)], "b": [Replicate(), Shard(0)], "scale": [Replicate(), Replicate()]}
    put = lambda tree: {k: distribute_tensor(v.clone(), mesh, placements[k]) for k, v in tree.items()}  # noqa: E731
    cfg = adamw.AdamWConfig(warmup_steps=0, total_steps=4, clip_norm=1.0)
    norm_whole = float(adamw.global_norm(grads))
    norm_sharded = float(adamw.global_norm(put(grads)))
    p_plain, _, m_plain = adamw.apply_updates({k: v.clone() for k, v in whole.items()}, grads,
                                              adamw.init_state(whole, cfg), cfg)
    params = put(whole)
    p_sh, _, m_sh = adamw.apply_updates(params, put(grads), adamw.init_state(params, cfg), cfg)
    return {"norm_whole": norm_whole, "norm_sharded": norm_sharded,
            "reported": [float(m_plain["grad_norm"]), float(m_sh["grad_norm"])],
            "params_max_diff": max(float((p_sh[k].full_tensor() - p_plain[k]).abs().max()) for k in whole)}


def case_serve(mesh) -> dict:
    from repro_torch.configs.base import ShapeSuite
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_api import build_model
    from repro_torch.runtime import serve_step as serve
    from repro_torch.sharding import dist
    from repro_torch.sharding.plan import make_plan

    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    plan0 = make_plan(cfg, None)
    B, S = 8, 31
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": toks}, plan0)
    cache = serve.pad_cache(cache, 1)
    tok = torch.argmax(last, -1).to(torch.int32)
    written = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        want, _ = model.decode(params, {"token": tok}, written, S, plan0)
    out = {}
    for variant in ("baseline", "serve", "zero"):
        step, p_sh, tok_sh, c_sh, _ = serve.jit_decode_step(model, mesh, ShapeSuite("d", S + 1, B, "decode"),
                                                            variant=variant)
        c = dist.distribute({k: v.clone() for k, v in cache.items()}, c_sh)
        logits, _ = step(dist.distribute(params, p_sh), dist.distribute({"token": tok}, tok_sh), c)
        out[variant] = {
            "logits_err": float((logits.full_tensor().float() - want.float()).abs().max()),
            # the new slot against the one the single-device step wrote, and every other slot unchanged
            "slot_err": max(float((c[n].full_tensor()[:, :, S].float() - written[n][:, :, S].float()).abs().max())
                            for n in ("k", "v")),
            "others_equal": all(bool(torch.equal(c[n].full_tensor()[:, :, :S], cache[n][:, :, :S])) for n in ("k", "v")),
        }
    out["wkv6"] = _wkv6_sharded(mesh)
    for variant in ("baseline", "zero"):
        step, p_sh, b_sh, _ = serve.jit_prefill_step(model, mesh, ShapeSuite("p", S, B, "prefill"), variant=variant)
        got, c = step(dist.distribute(params, p_sh), dist.distribute({"tokens": toks}, b_sh))
        out["prefill_" + variant] = {
            "logits_err": float((got.full_tensor().float() - last.float()).abs().max()),
            "cache_err": max(float((c[n].full_tensor().float() - cache[n][:, :, :S].float()).abs().max())
                             for n in ("k", "v"))}
    return out


def _wkv6_sharded(mesh) -> dict:
    """``ops.wkv6`` on DTensors (batch over data, heads over model, in the
    layouts a plan would leave them) against the same call on whole tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(4)
    B, T, H, K = 2, 20, 4, 8
    r, k, v = (torch.randn(B, T, H, K, generator=gen) for _ in range(3))
    logw = -torch.rand(B, T, H, K, generator=gen)
    u, s0 = torch.randn(H, K, generator=gen), torch.randn(B, H, K, K, generator=gen)
    want = ops.wkv6(r, k, v, logw, u, s0)
    put = lambda x, pl: distribute_tensor(x, mesh, pl)  # noqa: E731
    got = ops.wkv6(*(put(x, [Shard(0), Replicate()]) for x in (r, k, v, logw)), put(u, [Replicate(), Replicate()]),
                   put(s0, [Replicate(), Shard(1)]))
    return {"out_err": float((got[0].full_tensor() - want[0]).abs().max()),
            "state_err": float((got[1].full_tensor() - want[1]).abs().max()),
            "out_shard_dims": [p.dim if p.is_shard() else None for p in got[0].placements]}


CASES = {"train": case_train, "serve": case_serve}


def _rank_main(rank: int, case: str, shape, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh_shape

    torch.set_num_threads(1)
    world = int(np.prod(shape))
    tdist.init_process_group("gloo", store=tdist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                             world_size=world)
    try:
        result = CASES[case](make_mesh_shape(shape, ("data", "model"), device="cpu"))
        if rank == 0:
            Path(tmp, "result.json").write_text(json.dumps(result))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_ranks("train", MESH, tmp_path_factory.mktemp("train"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run_ranks("serve", MESH, tmp_path_factory.mktemp("serve"))


@pytest.mark.parametrize("arch,variant", [("granite-3-2b", "baseline"), ("granite-3-2b", "sp"),
                                          ("granite-3-2b", "zero"), ("stablelm-12b", "baseline")]
                         + [(arch, "zero") for arch in ZERO_ARCHS])
def test_sharded_train_step_matches_single_device(trained, arch, variant):
    got, want = trained[arch][variant], trained[arch]["single"]
    assert all(np.isfinite(got["loss"])) and len(got["loss"]) == 2
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) < 3e-2, (arch, variant, got, want)
    # the reductions across ranks: the first step's gradient, read through its
    # norm and the moment it left, and the second's norm
    assert abs(got["grad_norm"][0] - want["grad_norm"][0]) <= STEP1_GRAD_NORM_RTOL * want["grad_norm"][0], \
        (arch, variant, got, want)
    assert got["moment_err"][0] < STEP1_MOMENT_RTOL, (arch, variant, got)
    assert abs(got["grad_norm"][1] - want["grad_norm"][1]) <= STEP2_GRAD_NORM_RTOL * want["grad_norm"][1], \
        (arch, variant, got, want)


def test_global_norm_counts_sharded_and_replicated_leaves_once(trained):
    r = trained["norm"]
    assert abs(r["norm_sharded"] - r["norm_whole"]) <= 1e-6 * r["norm_whole"], r
    assert r["norm_whole"] > 1.0  # so the clip acts and a wrong norm would change the update
    assert abs(r["reported"][1] - r["reported"][0]) <= 1e-6 * r["reported"][0], r
    assert r["params_max_diff"] < 1e-6, r


@pytest.mark.parametrize("variant", ["baseline", "serve", "zero"])
def test_sharded_decode_matches_single_device(served, variant):
    r = served[variant]
    assert r["logits_err"] < 6e-2, r
    assert r["slot_err"] < 6e-2 and r["others_equal"], r


@pytest.mark.parametrize("variant", ["baseline", "zero"])
def test_sharded_prefill_matches_single_device(served, variant):
    r = served["prefill_" + variant]
    assert r["logits_err"] < 6e-2 and r["cache_err"] < 6e-2, r


def test_wkv6_takes_dtensors(served):
    r = served["wkv6"]
    assert r["out_err"] < 1e-5 and r["state_err"] < 1e-5, r
    assert r["out_shard_dims"] == [0, 2], r  # batch over data, heads over model


def test_launcher_mesh_host_under_torchrun_matches_mesh_none(tmp_path):
    args = ["--arch", "granite-3-2b", "--reduced", "--steps", "3", "--batch", "8", "--seq", "32",
            "--warmup", "1", "--log-every", "100", "--device", "cpu"]

    def run(cmd, name):
        out = subprocess.run(cmd + args + ["--metrics-out", str(tmp_path / name)], capture_output=True, text=True,
                             timeout=TIMEOUT_S, env=_env())
        assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
        return json.loads((tmp_path / name).read_text()), out.stdout

    single, _ = run([sys.executable, "-m", "repro_torch.launch.train", "--mesh", "none"], "none.json")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"]
    sharded, stdout = run(torchrun + ["-m", "repro_torch.launch.train", "--mesh", "host", "--ckpt-dir",
                                      str(tmp_path / "ckpt")], "host.json")
    assert stdout.count('"final_loss"') == 1  # rank 0 alone prints
    from repro_torch.checkpoint.store import CheckpointStore

    assert CheckpointStore(tmp_path / "ckpt").latest_step() == 3  # the whole state, written by rank 0
    for key in ("first_loss", "final_loss"):
        assert abs(sharded[key] - single[key]) < 3e-2, (key, sharded, single)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    case, shape, tmp = sys.argv[1], tuple(int(n) for n in sys.argv[2].split("x")), sys.argv[3]
    mp.spawn(_rank_main, args=(case, shape, tmp), nprocs=int(np.prod(shape)), join=True)
