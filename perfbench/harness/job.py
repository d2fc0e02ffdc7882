"""One training job of a cell: the program's training step, driven as its
launcher drives it (``repro_torch.launch.train.run``).

``Job`` builds the step from the configuration's registry name and fields
(``configs.registry.get_config`` -> ``models.model_api.build_model`` ->
``runtime.train_step.build_train_step`` with ``optim.adamw``), gives it the
benchmark's weights (``harness.weights``) and a zero AdamW state, and feeds
it through the program's ``data.pipeline.HostPipeline`` with the
benchmark's batches (``harness.feed``). A step is the launcher's loop body:
the next batch to the device, the step, and the loss read back, which waits
for the step's work.

``setup`` runs the first ``checked_steps`` steps, which also warm up every
shape, and reads from the program's state what the check compares: the
losses, each leaf's first gradient as the optimizer took it (its first
moment after one step, over 1 - b1) and each leaf's change after the last
checked step. ``check`` frees the program's state and follows the same steps
with the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from harness import check, feed, weights

CHUNK = 1 << 25


def program_config(spec: dict):
    from repro_torch.configs.registry import get_config

    prog = spec["config_data"]["program"]
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in prog["fields"].items()}
    return dataclasses.replace(get_config(prog["arch"]), **fields)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    def __init__(self, spec: dict, seed: int, device):
        from repro_torch.data.pipeline import HostPipeline
        from repro_torch.launch.train import cudnn_flags
        from repro_torch.models.model_api import build_model
        from repro_torch.optim import adamw
        from repro_torch.runtime import train_step as ts
        from repro_torch.sharding.plan import make_plan

        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        traffic = spec["traffic_data"]
        opt = traffic["optimizer"]
        self.cfg = program_config(spec)
        model = build_model(self.cfg)
        self.opt_cfg = adamw.AdamWConfig(**{k: opt[k] for k in (
            "lr_peak", "lr_min", "warmup_steps", "total_steps", "b1", "b2", "eps", "weight_decay", "clip_norm")})
        self.step_fn = ts.build_train_step(model, make_plan(self.cfg, None), self.opt_cfg,
                                           grad_accum=traffic["grad_accum"])
        meta = model.init(torch.Generator(device="cpu"), "meta")
        self.layout = [(path, tuple(t.shape), t.dtype) for path, t in weights.paths(meta)]
        params = weights.unflatten(self.layout, weights.leaves(self.layout, seed, self.device))
        self.state = {"params": params, "opt": adamw.init_state(params, self.opt_cfg)}
        self.flags = cudnn_flags()
        self.flags.__enter__()
        self.pipeline = HostPipeline(lambda step: feed.batch(spec, seed, step), workers=traffic["workers"],
                                     max_queue_size=traffic["max_queue_size"]).start()
        self.losses = []

    def step(self) -> float:
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in self.pipeline.get().items()}
        self.state, metrics = self.step_fn(self.state, batch)
        loss = float(metrics["loss"])
        self.losses.append(loss)
        return loss

    def setup(self) -> dict:
        """The checked steps; returns the program's readout of them."""
        keys = ["/".join(path) for path, _, _ in self.layout]
        n = self.spec["traffic_data"]["checked_steps"]
        out = {"losses": [], "grad": {}, "update": {}}
        for i in range(n):
            out["losses"].append(self.step())
            if i == 0:
                ms = [m for _, m in weights.paths(self.state["opt"].m)]
                out["grad"] = {k: float(m.float().norm()) / (1 - self.opt_cfg.b1) for k, m in zip(keys, ms)}
        ps = [p for _, p in weights.paths(self.state["params"])]
        with torch.no_grad():
            for i, (k, p) in enumerate(zip(keys, ps)):
                p0 = weights.make_leaf(self.layout, i, self.seed, self.device)
                sq = sum(float((a.float() - b.float()).square().sum())
                         for a, b in zip(p.reshape(-1).split(CHUNK), p0.reshape(-1).split(CHUNK)))
                out["update"][k] = math.sqrt(sq)
                del p0
        _sync(self.device)
        return out

    def run_until(self, deadline: float) -> list:
        """Steps until one ends at or after ``deadline`` (perf_counter);
        returns each step's end."""
        ends = []
        while True:
            self.step()
            ends.append(time.perf_counter())
            if ends[-1] >= deadline:
                return ends

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def free(self) -> None:
        self.pipeline.stop()
        self.flags.__exit__(None, None, None)
        self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, readout: dict) -> dict:
        """Frees the program's state, follows the checked steps with the
        reference (f32, TF32 off) and returns the numbers."""
        from reference import train as ref

        self.free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        got = ref.follow(self.spec, self.seed, self.layout, self.spec["traffic_data"]["checked_steps"], self.device)
        self.reference_s = time.perf_counter() - t0
        return check.numbers(readout, got, self.spec.get("loss_steps"))
