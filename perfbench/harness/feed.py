"""The inputs of a cell, made from the seed on the host.

One batch a step, a pure function of (seed, step): the same seed gives the
same inputs, and every step's rows differ. The program's input pipeline
(``repro_torch.data.pipeline.HostPipeline``) calls ``batch`` from its worker
thread; the reference calls it again after the window for the steps it
follows. Token batches are next-token pairs over a uniform stream; image
batches are N(0, 1) pixels (NHWC, f32) and uniform labels.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def batch(spec: dict, seed: int, step: int) -> Dict[str, np.ndarray]:
    inputs, traffic = spec["config_data"]["inputs"], spec["traffic_data"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    b = traffic["batch"]
    if inputs["kind"] == "tokens":
        stream = rng.integers(0, inputs["vocab"], (b, traffic["seq"] + 1), dtype=np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    if inputs["kind"] == "images":
        s = inputs["size"]
        return {"images": rng.standard_normal((b, s, s, 3), dtype=np.float32),
                "labels": rng.integers(0, inputs["classes"], (b,), dtype=np.int32)}
    raise ValueError(f"unknown kind of input {inputs['kind']!r}")


def items_per_step(spec: dict) -> int:
    """Tokens (or images) one step of one job trains on."""
    traffic = spec["traffic_data"]
    per_row = traffic["seq"] if spec["config_data"]["inputs"]["kind"] == "tokens" else 1
    return traffic["batch"] * per_row
