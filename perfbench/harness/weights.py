"""The weights of a cell, made on the device from the seed.

The benchmark makes them, not the program: the program and the reference
both start from these bits. The tree's layout (paths, shapes and types) is
the program's parameter layout, handed in as ``layout``: ``[(path, shape,
dtype), ...]`` in the order of the program's tree. Each leaf is drawn by a
generator on the device seeded from (seed, leaf index), so any leaf can be
made again alone, in the type it is trained in:

  * ``scale`` (a norm's gain): ones; ``bias`` and ``b``: zeros;
  * a 4-d (kh, kw, cin, cout) kernel: N(0, 2 / (kh kw cin)) (He);
  * the embedding ``table`` (rows, d): N(0, 1 / d);
  * any other matrix (..., in, out): N(0, 1 / in).
"""
from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import torch

Layout = List[Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype]]


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index) % (1 << 63)


def std_of(path: Tuple[str, ...], shape: Tuple[int, ...]) -> float:
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
    if path[-1] == "table":
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])


def make_leaf(layout: Layout, index: int, seed: int, device) -> torch.Tensor:
    path, shape, dtype = layout[index]
    if path[-1] == "scale":
        return torch.ones(shape, dtype=dtype, device=device)
    if path[-1] in ("bias", "b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std_of(path, shape))


def leaves(layout: Layout, seed: int, device) -> Iterator[torch.Tensor]:
    for i in range(len(layout)):
        yield make_leaf(layout, i, seed, device)


def unflatten(layout: Layout, values) -> dict:
    """A nested dict (lists where a path step is an index of a list) of
    ``values`` at the layout's paths."""
    root: dict = {}
    for (path, _, _), value in zip(layout, values):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def paths(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every leaf of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from paths(val, prefix + (str(key),))
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from paths(val, prefix + (str(i),))
    else:
        yield prefix, tree
