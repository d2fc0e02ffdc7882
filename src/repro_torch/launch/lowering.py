"""Step builders shared by the characterization and the dry-run (PyTorch
twin of ``repro.launch.lowering``).

The reference lowers a step function on a mesh and hands back the compiled
program for its costs. PyTorch runs eagerly and has no program to hand back:

  * ``build_cell`` builds what ``launch/train.py`` builds, on one device,
    ready to run and to measure (``core/instance.py``);
  * ``lower_cell`` builds the sharded step of ``runtime/`` on a mesh and
    traces one call of it on fake tensors (``FakeTensorMode``: shapes and
    types, no storage, nothing runs) under the op counters, which also
    follow the storages the step holds live, as rank 0 of the mesh sees it. What it returns stands for
    the reference's lowered program: per-device FLOPs and bytes by the
    reference's traffic model (``telemetry/hlo.py``), collectives, the memory
    a device holds, and a fingerprint of the op sequence. The mesh is a
    ``DeviceMesh`` over a fake process group (``fake_world``), whose
    collectives move nothing. Off the card every kernel wrapper takes its
    plain version, as the reference's ``ops`` take their ``ref`` path off the
    TPU, so the memory is the plain path's: its attention materializes the
    score matrix, which the card's kernels never hold.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic
from repro_torch.models.model_api import build_model
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw
from repro_torch.runtime import serve_step as serve
from repro_torch.runtime import train_step as ts
from repro_torch.sharding import dist
from repro_torch.sharding.plan import make_plan


def active_params(cfg, total: int) -> int:
    """Params touched per token (MoE: shared + top_k routed experts only)."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    inactive_experts = m.n_experts - m.top_k
    per_expert = 3 * cfg.d_model * m.d_expert
    return total - cfg.n_layers * inactive_experts * per_expert


def _batch(cfg, suite: ShapeSuite, seed: int) -> dict:
    if cfg.family == "resnet":
        # the config's own image size and classes, so that its CPU-scale form
        # gets images of its size (at full size the paper's dataset's)
        spec = synthetic.DatasetSpec(cfg.name, 0, 0, image_size=cfg.img_size, n_classes=cfg.n_classes)
        return synthetic.image_batch(spec, suite.global_batch, seed=seed)
    return synthetic.batch_for(cfg, suite, seed=seed)


def build_cell(cfg, suite: ShapeSuite, device, *, seed: int = 0):
    """The train step of the model ``cfg`` under ``suite`` on ``device``, as
    the launcher builds it: the model, random parameters and a zero AdamW
    state from ``seed``, the synthetic batch of step 0 on ``device``, and the
    step function. Returns ``(model, state, batch, step)``.

    Train suites only: prefill and decode cells are not ported yet
    (ROADMAP.md, Queue 1).
    """
    if suite.kind != "train":
        raise NotImplementedError(
            f"suite {suite.name!r} is a {suite.kind} suite: only train suites are "
            "characterized by the port yet (ROADMAP.md, Queue 1)"
        )
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    step = ts.build_train_step(model, make_plan(cfg, None), opt_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = ts.init_train_state(model, gen, opt_cfg, device)
    batch = {
        k: torch.from_numpy(np.asarray(v)).to(device)
        for k, v in _batch(cfg, suite, seed).items()
    }
    return model, state, batch, step


# ---------------------------------------------------------------------------
# the dry-run's lowering: one traced call on fake tensors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0,
    for the block: the twin of the reference's placeholder host devices. Its
    collectives return at once and move nothing; a ``DeviceMesh`` of
    ``device="cpu"`` over it lowers a production mesh on a host. The process
    must have no process group of its own."""
    import torch.distributed as tdist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)

    if tdist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    tdist.init_process_group("fake", store=tdist.HashStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        tdist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Lowered:
    """What ``lower_cell`` traced: per-device FLOPs and HBM bytes (the
    reference's traffic model), the collective summary, the memory a device
    holds under the reference's ``memory_analysis`` names, the fingerprint of
    the op sequence, and the type the products compute in."""

    flops: float
    bytes: float
    collectives: Dict
    memory: Dict[str, int]
    fingerprint: str
    product_dtype: torch.dtype


def _fake_tree(specs, shardings):
    """Fake DTensors shaped by ``specs`` (``(shape, dtype)`` leaves, or
    tensors on the meta device) in the placements of ``shardings``; a 0-d
    leaf stays a plain tensor, as ``dist.distribute`` leaves it."""
    from torch.distributed.tensor import empty

    if isinstance(specs, dict):
        return {k: _fake_tree(v, shardings[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_fake_tree(v, s) for v, s in zip(specs, shardings)]
    shape, dtype = (tuple(specs.shape), specs.dtype) if isinstance(specs, torch.Tensor) else specs
    if not shape:
        return torch.zeros((), dtype=dtype)
    return empty(shape, dtype=dtype, device_mesh=shardings.mesh, placements=shardings.placements)


def _storages(tree) -> Dict[int, int]:
    """{storage: bytes} of the local shards of ``tree``'s tensors (dicts,
    lists, tuples and named tuples)."""
    from torch.utils._pytree import tree_flatten

    locals_ = [dist.local(t) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in locals_}


def lower_cell(arch: str, suite: ShapeSuite, mesh, *, grad_accum: int = 1,
               variant: str = "baseline", remat: bool | None = None):
    """Trace the real step function for (arch, suite) on ``mesh`` (the
    reference's ``lower_cell``): train shapes -> ``jit_train_step`` (forward,
    backward, AdamW), prefill shapes -> ``jit_prefill_step``, decode shapes ->
    ``jit_decode_step`` at the last cache slot. The state, params, batch and
    cache are fake DTensors in the step's shardings. Returns
    ``(cfg, model, lowered)``; ``remat=None`` keeps the config's default.

    ``lowered.memory``: ``argument_bytes`` the local shards of the step's
    inputs, ``output_bytes`` of what it returns, ``alias_bytes`` of the
    outputs that are inputs updated in place (the state, the decode cache),
    ``temp_bytes`` what the counters saw live at the step's peak beyond
    those (``OpLog.peak``), and ``peak_bytes_per_device`` = argument +
    output - alias + temp, the reference's sum.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.telemetry.counts import OpLog, _alltoall_recorded, collective_summary, propagation_apart
    from repro_torch.telemetry.hlo import hlo_flops_bytes

    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        if suite.kind == "train":
            opt = adamw.AdamWConfig()
            step, st_sh, b_sh, _ = ts.jit_train_step(model, mesh, suite, opt, grad_accum=grad_accum, variant=variant)
            shapes = ts.param_shapes(model)
            moments = tree_map(lambda p: (tuple(p.shape), opt.mu_dtype), shapes)
            state = {"params": _fake_tree(shapes, st_sh["params"]),
                     "opt": adamw.AdamWState(torch.zeros((), dtype=torch.int32), _fake_tree(moments, st_sh["params"]),
                                             _fake_tree(moments, st_sh["params"]))}
            args = (state, _fake_tree(model.input_specs(suite), b_sh))
        elif suite.kind == "prefill":
            step, p_sh, b_sh, _ = serve.jit_prefill_step(model, mesh, suite, variant=variant)
            args = (_fake_tree(ts.param_shapes(model), p_sh), _fake_tree(model.input_specs(suite), b_sh))
        else:
            step, p_sh, tok_sh, c_sh, _ = serve.jit_decode_step(model, mesh, suite, variant=variant)
            args = (_fake_tree(ts.param_shapes(model), p_sh), _fake_tree(model.input_specs(suite), tok_sh),
                    _fake_tree(model.cache_spec(suite.global_batch, suite.seq_len), c_sh))
        inputs = _storages(args)
        log = OpLog()
        log.hold(args)
        with propagation_apart(), _alltoall_recorded(log), log:
            out = step(*args)
    outputs = _storages(out)
    arg_b, out_b = sum(inputs.values()), sum(outputs.values())
    alias_b = sum(n for s, n in outputs.items() if s in inputs)
    temp_b = max(0, log.peak - arg_b - (out_b - alias_b))
    dtypes = log.product_dtypes.most_common(1)
    lowered = Lowered(
        flops=log.flops,
        bytes=hlo_flops_bytes(log, args)["bytes"],
        collectives=collective_summary(log.collectives),
        memory={"argument_bytes": arg_b, "output_bytes": out_b, "alias_bytes": alias_b, "temp_bytes": temp_b,
                "peak_bytes_per_device": arg_b + out_b - alias_b + temp_b},
        fingerprint=log.fingerprint(),
        product_dtype=dtypes[0][0] if dtypes else torch.bfloat16,
    )
    return cfg, model, lowered
