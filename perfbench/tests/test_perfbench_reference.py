"""The plain reference: its blocked attention against the textbook formula,
and its first steps against the program's at a tiny size on the CPU."""
import math

import pytest
import torch

from conftest import AGREE, tiny_spec
from harness import check
from harness.job import Job
from reference import train as ref
from reference import transformer


def test_blocked_attention_matches_the_formula(monkeypatch):
    monkeypatch.setattr(transformer, "ATTN_ROWS", 4)
    gen = torch.Generator().manual_seed(0)
    B, KVH, G, S, D = 2, 2, 3, 10, 8
    q = torch.randn(B, KVH, G, S, D, generator=gen, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, KVH, S, D, generator=gen, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, KVH, S, D, generator=gen, dtype=torch.float64, requires_grad=True)
    do = torch.randn(B, KVH, G, S, D, generator=gen, dtype=torch.float64)
    o = transformer.CausalAttention.apply(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) / math.sqrt(D)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    o_ref = torch.einsum("bhgqk,bhkd->bhgqd", s.softmax(-1), v)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.testing.assert_close(o, o_ref, rtol=1e-10, atol=1e-10)
    for g, r in zip(grads, grads_ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("cell", ["granite-train-4k", "resnet50-naive-x7"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_follows_the_program(cell, seed):
    spec = tiny_spec(cell, jobs=1)
    job = Job(spec, seed, "cpu")
    readout = job.setup()
    job.free()
    got = ref.follow(spec, seed, job.layout, spec["traffic_data"]["checked_steps"], "cpu")
    nums = check.numbers(readout, got, spec.get("loss_steps"))
    agree = AGREE[spec["config_data"]["model"]["family"]]
    assert all(nums[k] <= agree[k] for k in check.NUMBERS), nums
    assert len(got["losses"]) == spec["traffic_data"]["checked_steps"]
