"""How far two roundings of attention carry a deepseek-moe-16b prefill apart,
layer by layer, on one NVIDIA GPU.

Three prefills of the same requests (batch 8, prompt 2048, random weights
from seed 0, as ``chip_smoke.py`` serves them): through the kernels, through
the non-kernel path (``chip_smoke.torch_attention_path``: the blocked
attention that rounds q * scale to bf16) and through the plain f32 attention
(``chip_smoke.f32_attention_path``: no bf16 rounding of q * scale or of p).
The second and third route by the first one's expert choices
(``chip_smoke.routes_recorded``), so that only the attention's roundings
differ. For each pair it prints the relative L2 distance of every layer's
MoE input and output, how many top-k sets each run's own router would have
chosen otherwise, and the distance of the last logits. Where the kernels lie
no farther from the non-kernel path than the f32 attention does, the drift
is the model's and not the kernels'; ``chip_smoke.SPREAD_LIMIT`` rests on it.

    PYTHONPATH=src python examples/profile_moe_drift_torch.py

The first line of output is the card's name and power limit, then one JSON
line a pair.
"""
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as c  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@contextlib.contextmanager
def moe_io(store: list):
    """Inside the block every MoE layer call appends (its input, its output)."""
    saved = moe.moe_ffn

    def kept(cfg, p, x, plan, capacity_factor=None):
        y, aux = saved(cfg, p, x, plan, capacity_factor)
        store.append((x.clone(), y.clone()))
        return y, aux

    moe.moe_ffn = kept
    try:
        yield
    finally:
        moe.moe_ffn = saved


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = c.get_config(c.DEEPSEEK_ARCH)
    model, plan = c.build_model(cfg), c.make_plan(cfg, None)
    params = model.init(torch.Generator(device=c.DEV).manual_seed(0), c.DEV)
    tokens = c.from_jax_params(c.synthetic.token_batch(cfg.vocab, c.BATCH, c.PROMPT, seed=7), c.DEV)["tokens"]
    runs, routes = {}, {}
    for name, path in (("kernels", contextlib.nullcontext), ("torch_path", c.torch_attention_path),
                       ("f32_path", c.f32_attention_path)):
        io: list = []
        chosen: list = []
        with torch.no_grad(), path(), moe_io(io), c.routes_recorded(chosen, routes.get("kernels")):
            last, _ = model.prefill(params, {"tokens": tokens}, plan)
        torch.cuda.synchronize()
        runs[name], routes[name] = (io, last), chosen
    for a, b in (("kernels", "torch_path"), ("f32_path", "torch_path"), ("kernels", "f32_path")):
        (io_a, last_a), (io_b, last_b) = runs[a], runs[b]
        print(json.dumps({
            "pair": [a, b], "arch": cfg.name, "batch": c.BATCH, "prompt": c.PROMPT,
            "moe_input_rel_l2_by_layer": [rel(x, y) for (x, _), (y, _) in zip(io_a, io_b)],
            "moe_output_rel_l2_by_layer": [rel(x, y) for (_, x), (_, y) in zip(io_a, io_b)],
            "own_top_k_sets_differing_by_layer": [
                int((p.sort(-1).values != q.sort(-1).values).any(-1).sum()) for p, q in zip(routes[a], routes[b])],
            "top_k_sets_a_layer": routes[a][0].shape[0],
            "last_logits_rel_l2": rel(last_a, last_b),
            "last_logits_max_abs_diff": float((last_a.float() - last_b.float()).abs().max()),
        }), flush=True)


if __name__ == "__main__":
    main()
