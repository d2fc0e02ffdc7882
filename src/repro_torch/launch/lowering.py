"""Step builders shared by the characterization and the dry-run (PyTorch
twin of ``repro.launch.lowering``).

The reference lowers a step function on a mesh and hands back the compiled
program for its costs. PyTorch runs eagerly and has no program to hand back:

  * ``build_cell`` builds the step of a train, prefill or decode suite, on
    one device, ready to run and to measure (``core/instance.py``);
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

import torch

from repro_torch.configs.base import ShapeSuite
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
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


def build_cell(cfg, suite: ShapeSuite, device, *, seed: int = 0, grad_accum: int = 1):
    """The step of the model ``cfg`` under ``suite`` on ``device``, with random
    parameters from ``seed`` and the synthetic batch of step 0 on ``device``,
    as the reference's ``lower_cell`` builds it. Returns ``(model, state,
    batch, step)``; ``step(state, batch)`` returns ``(state, out)``:

      * train suites: the launcher's train step (``grad_accum`` microbatches
        a step, ``runtime/train_step.py``), its state the parameters and a
        zero AdamW state, ``out`` its metrics (``"loss"``);
      * prefill suites: the model's prefill of the batch at the suite's batch
        and length; the state is the parameters, ``out["logits"]`` the last
        position's logits;
      * decode suites: one decode step at the last slot of
        ``model.cache_spec(global_batch, seq_len)``, the cache filled first by a
        prefill of ``seq_len - 1`` tokens and the token its greedy choice, as
        ``greedy_generate`` does; the state is ``{"params", "cache"}`` (the step
        writes its slot in place), ``out["logits"]`` the step's logits.
    """
    model = build_model(cfg)
    plan = make_plan(cfg, None)
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = from_jax_params(_batch(cfg, suite, seed), device)
    if suite.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        step = ts.build_train_step(model, plan, opt_cfg, grad_accum=grad_accum)
        return model, ts.init_train_state(model, gen, opt_cfg, device), batch, step
    if grad_accum != 1:
        raise ValueError(f"a {suite.kind} suite takes no gradient accumulation, not {grad_accum}")
    params = model.init(gen, device)
    batch.pop("labels", None)
    if suite.kind == "prefill":
        prefill = serve.build_prefill(model, plan)

        def prefill_step(state, batch):
            last, _ = prefill(state, batch)
            return state, {"logits": last}

        return model, params, batch, prefill_step
    S = suite.seq_len  # a decode suite
    prompt = dict(batch, tokens=batch["tokens"][:, : S - 1])
    last, cache = serve.build_prefill(model, plan)(params, prompt)
    cache = serve.pad_cache(cache, 1)
    decode = serve.build_decode(model, plan, S - 1)
    token = torch.argmax(last, dim=-1).to(torch.int32)
    step_batch = {"token": token}
    if "frames" in batch:  # the encoder-decoder's input, as the decode step's input_specs name it
        step_batch["frames"] = batch["frames"]

    def decode_step(state, batch):
        logits, _ = decode(state["params"], batch, state["cache"])
        return state, {"logits": logits}

    return model, {"params": params, "cache": cache}, step_batch, decode_step


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
