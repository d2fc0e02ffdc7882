"""GPipe-style pipeline parallelism over a ``stage`` mesh dim — the PyTorch
twin of ``repro.runtime.pipeline``.

A self-contained microbatch pipeline for the stacked-layer dense
transformer: stage s owns layers [s*L/S, (s+1)*L/S); activations flow stage
to stage by point-to-point send/recv (the reference's ``collective_permute``);
the classic GPipe schedule runs (M + S - 1) ticks with bubble fraction
(S-1)/(M+S-1). Forward only, as the reference uses it; its oracle is the
plain forward (``tests/test_torch_ring_pipeline.py``).

Every rank of the stage dim calls ``pipeline_forward`` with the whole
parameter tree (each uses the views of its own layers) and the same tokens.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as tdist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as nn
from repro_torch.models import transformer as tfm
from repro_torch.sharding.plan import ShardingPlan


@torch.no_grad()
def pipeline_forward(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # (M, mb, S) microbatched token ids
    mesh,
    *,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Pipelined forward producing logits (M, mb, S, V) f32 on every rank.

    ``params['layers']`` leaves have leading dim L = n_layers; the stage dim's
    size must divide L. The embedding runs on the first stage, the head on
    the last, which then shares the logits with every rank (a broadcast: the
    reference's psum of the last stage's logits and the others' zeros).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"pipeline_forward takes the dense family, as the reference's; not {cfg.family}")
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    sid = mesh.get_local_rank(stage_axis)
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"{n_stages} stages do not divide {L} layers")
    per_stage = L // n_stages
    M, mb, S = tokens.shape
    plan = ShardingPlan(None, {}, (), None)
    layers = nn.slice_layers(params["layers"], sid * per_stage, (sid + 1) * per_stage)
    body = functools.partial(tfm.block_fwd, cfg, plan)
    prev = tdist.get_global_rank(group, sid - 1) if sid > 0 else None
    nxt = tdist.get_global_rank(group, sid + 1) if sid < n_stages - 1 else None
    last = tdist.get_global_rank(group, n_stages - 1)

    h_out = torch.zeros((M, mb, S, cfg.d_model), dtype=torch.bfloat16, device=tokens.device)
    sending = []
    for t in range(M + n_stages - 1):
        m_idx = t - sid  # the microbatch this stage works on at tick t
        if not 0 <= m_idx < M:
            continue
        if sid == 0:
            x = nn.embedding_apply(params["embed"], tokens[m_idx])
        else:
            x = torch.empty((mb, S, cfg.d_model), dtype=torch.bfloat16, device=tokens.device)
            tdist.recv(x, prev, group=group)
        y = nn.scan_layers(body, x, layers)
        if nxt is not None:
            for req in sending:  # the previous tick's activation has left
                req.wait()
            sending = [tdist.isend(y, nxt, group=group)]
        else:
            h_out[m_idx] = y
    for req in sending:
        req.wait()

    logits = torch.empty((M, mb, S, cfg.padded_vocab), dtype=torch.float32, device=tokens.device)
    if sid == n_stages - 1:
        logits.copy_(tfm.logits_fn(cfg, params, h_out, plan).float())
    tdist.broadcast(logits, last, group=group)
    return logits
