"""Minimal functional module substrate (PyTorch twin of ``repro.models.module``).

Parameters are nested dicts (and, as the ResNet's blocks, lists) of tensors,
built by pure ``init`` functions and consumed by pure ``apply`` functions. Where the reference stacks layer
parameters on a leading ``L`` dim and scans over them, the port keeps the
same stacked leaves (so a converted reference tree needs no re-layout) and
loops over ``L`` in Python, over views of each leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def trunc_normal(
    gen: torch.Generator, shape: Sequence[int], std: float, dtype, device
) -> torch.Tensor:
    """Truncated-normal(±2σ) initializer (the common transformer default)."""
    # inverse-CDF sampling: uniform over [cdf(-2), cdf(2)], then the normal quantile
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=gen)
    out.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return out.to(dtype)


def fan_in_init(
    gen: torch.Generator, shape: Sequence[int], dtype, device, scale: float = 1.0
) -> torch.Tensor:
    """LeCun-style fan-in init for (..., in, out)-shaped kernels.

    A stacked kernel ``(L, in, out)`` takes its fan-in from ``shape[-2]``, so
    one call initializes every layer of a stack.
    """
    fan_in = shape[-2] if len(shape) >= 2 else max(math.prod(shape), 1)
    std = scale / math.sqrt(max(fan_in, 1))
    return trunc_normal(gen, shape, std, dtype, device)


def zeros_init(_gen: Optional[torch.Generator], shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Zeros; takes (and ignores) a generator, as the reference's takes a key."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, *, device, dtype=torch.bfloat16, bias: bool = False,
    scale: float = 1.0,
) -> Params:
    """``{"w": (d_in, d_out)}`` by ``fan_in_init`` (and ``"b"`` of zeros), as the reference's."""
    p: Params = {"w": fan_in_init(gen, (d_in, d_out), dtype, device, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def dense_apply(p: Params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with ``w`` stored (in, out), as the reference stores it."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def embedding_apply(p: Params, ids: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return torch.nn.functional.embedding(ids.long(), p["table"]).to(compute_dtype)


def rmsnorm_init(d: int, *, device, dtype=torch.float32, stack: Sequence[int] = ()) -> Params:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def layernorm_init(d: int, *, device, dtype=torch.float32, stack: Sequence[int] = ()) -> Params:
    return {
        "scale": torch.ones((*stack, d), dtype=dtype, device=device),
        "bias": torch.zeros((*stack, d), dtype=dtype, device=device),
    }


def layernorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float = 10_000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, each (..., seq, 1, head_dim // 2), f32.

    They depend on the positions only, so a caller that rotates q and k of
    every layer at the same positions computes them once and hands them to
    ``apply_rope``.
    """
    inv_freq = rope_frequencies(head_dim, theta, positions.device)  # (hd/2,)
    angles = positions[..., None].float() * inv_freq  # (..., seq, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    *,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Uses the split-halves convention (llama-style), f32 inside. ``tables``
    are ``rope_tables(positions, head_dim, theta)`` where the caller has them.
    """
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# stacked-layer utilities (loop over depth)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path of dict keys and list indices, leaf) of every leaf of nested
    dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from tree_paths(val, prefix + (str(key),))
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from tree_paths(val, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    return (leaf for _, leaf in tree_paths(tree))


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves, in ``tree_leaves`` order, are ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked-params tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def unbind_layers(stacked: Params) -> List[Params]:
    """All layers of a stacked-params tree as views, one ``unbind`` per leaf.

    Under autograd this matters: ``a[i]`` of a stacked leaf sends back, in
    backward, a zero-filled gradient of the whole leaf for every layer, while
    one ``unbind`` sends back one ``stack`` of the per-layer gradients.
    """
    n_layers = next(tree_leaves(stacked)).shape[0]
    layers: List[Params] = [{} for _ in range(n_layers)]

    def walk(node: Params, outs: List[Params]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                subs = [out.setdefault(key, {}) for out in outs]
                walk(val, subs)
            else:
                for out, view in zip(outs, val.unbind(0)):
                    out[key] = view

    walk(stacked, layers)
    return layers


def scan_layers(
    body: Callable[[Any, Params], Any], carry: Any, stacked: Params, *, remat: bool = False
):
    """Run ``carry = body(carry, layer_params)`` across the stacked dim.

    The reference scans so that its lowered program is O(1) in depth; eager
    PyTorch has no such program, so this is a Python loop. ``remat=True`` is
    the twin of ``jax.checkpoint`` around the body: each layer keeps only its
    input for backward and runs its forward again there.
    """
    for lp in unbind_layers(stacked):
        if remat and torch.is_grad_enabled():
            carry = torch.utils.checkpoint.checkpoint(body, carry, lp, use_reentrant=False)
        else:
            carry = body(carry, lp)
    return carry


def slice_layers(stacked: Params, start: int, stop: int) -> Params:
    """Layers ``[start, stop)`` of a stacked-params tree (views, no copy)."""
    return tree_map(lambda a: a[start:stop], stacked)


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
