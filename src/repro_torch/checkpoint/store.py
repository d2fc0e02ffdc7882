"""Checkpoint store: atomic manifests, async saves, resume (PyTorch twin of
``repro.checkpoint.store``).

Same contract and the same files as the reference, so a checkpoint written by
either package is restored by the other:

  * ``<root>/step_<n:08d>/`` holds one ``.npy`` per leaf, named by the leaf's
    key (``opt/m/embed/table`` -> ``opt__m__embed__table.npy``), and
    ``manifest.json`` with each leaf's key, shape, type and crc32;
  * a checkpoint is VALID iff its manifest exists — it is written LAST and
    renamed into place atomically, so a writer killed mid-save never leaves a
    readable-but-corrupt step;
  * ``save(..., async_save=True)`` copies every leaf to the host first and
    writes on a background thread; the previous async save is joined before a
    new one begins (bounded memory);
  * ``restore`` rebuilds a tree shaped like the one it is given, on the device
    of each of its leaves, and checks every crc32.

One host, one shard per leaf: the reference's per-shard files degenerate to
one file a leaf there too. bfloat16, which numpy lacks, is stored as its
16-bit patterns in a ``V2`` array with ``"bfloat16"`` in the manifest, which
is how ``np.save`` writes the reference's ``ml_dtypes`` arrays; no
``ml_dtypes`` is needed to read or write one.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """("a/b/c", leaf) in the reference's order: dict keys sorted, named
    tuples by field, sequences by index."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_paths(tree[key], prefix + (str(key),))
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaf_paths(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, leaves: Iterator[Any]):
    """A tree shaped like ``tree`` whose leaves, in ``_leaf_paths`` order, are ``leaves``."""
    if isinstance(tree, dict):
        built = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: built[key] for key in tree}  # the caller's key order
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and its type's name in the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        # snapshot semantics: np leaves must be COPIED, or an async writer
        # would observe later caller mutations
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The inverse of ``_to_numpy``; also reads the reference's ``V2`` bfloat16 files."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype.kind == "V":
        raise TypeError(f"raw {arr.dtype} data for a leaf of type {dtype!r}")
    return torch.from_numpy(np.array(arr)).to(device)


@dataclasses.dataclass
class CheckpointInfo:
    step: int
    path: Path
    wall_time: float


class CheckpointStore:
    """Directory layout: <root>/step_<n>/{leaf files, manifest.json}."""

    def __init__(self, root: str | Path, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------------

    def save(self, step: int, tree, *, extra: Optional[Dict] = None,
             async_save: bool = False) -> Path:
        """Save ``tree`` (nested dicts / named tuples of tensors or arrays) at ``step``."""
        self.wait()  # join any in-flight async save (bounded memory)
        # device->host copy NOW so the caller may update the tree in place afterwards
        host_leaves = [(key, *_to_numpy(leaf)) for key, leaf in _leaf_paths(tree)]
        if async_save:
            t = threading.Thread(target=self._write, args=(step, host_leaves, extra), daemon=True)
            t.start()
            self._async_thread = t
            return self.root / f"step_{step:08d}"
        return self._write(step, host_leaves, extra)

    def _write(self, step, host_leaves, extra) -> Path:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        leaves_meta = []
        for key, arr, dtype in host_leaves:
            fname = key.replace("/", "__") + ".npy"
            with open(tmp / fname, "wb") as f:
                np.save(f, arr)
            leaves_meta.append({
                "key": key,
                "shape": list(arr.shape),
                "dtype": dtype,
                "shards": [{"file": fname, "index": 0, "crc32": zlib.crc32(arr.tobytes())}],
            })
        manifest = {"step": step, "wall_time": time.time(), "leaves": leaves_meta, "extra": extra or {}}
        # manifest LAST + atomic rename = crash consistency
        mtmp = tmp / (MANIFEST + ".tmp")
        mtmp.write_text(json.dumps(manifest, indent=1))
        mtmp.rename(tmp / MANIFEST)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self):
        for info in self.list()[: -self.keep]:
            shutil.rmtree(info.path, ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def list(self) -> List[CheckpointInfo]:
        out = []
        for d in sorted(self.root.glob("step_*")):
            man = d / MANIFEST
            if not man.exists():
                continue  # incomplete save — invisible by contract
            meta = json.loads(man.read_text())
            out.append(CheckpointInfo(meta["step"], d, meta["wall_time"]))
        return out

    def latest_step(self) -> Optional[int]:
        ckpts = self.list()
        return ckpts[-1].step if ckpts else None

    def restore(self, tree_like, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``tree_like``; returns (tree, extra).

        Each leaf goes to the device of the matching leaf of ``tree_like``
        when that is a tensor (a ``meta`` tensor gives the CPU), else to the
        CPU. Shards of a leaf saved by several hosts are joined on axis 0.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        meta = json.loads((d / MANIFEST).read_text())
        by_key = {m["key"]: m for m in meta["leaves"]}

        leaves = []
        for key, like in _leaf_paths(tree_like):
            m = by_key[key]
            parts = []
            for smeta in sorted(m["shards"], key=lambda s: s["index"]):
                with open(d / smeta["file"], "rb") as f:
                    arr = np.load(f)
                if zlib.crc32(arr.tobytes()) != smeta["crc32"]:
                    raise IOError(f"crc mismatch in {d / smeta['file']}")
                parts.append(arr)
            full = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            if list(full.shape) != m["shape"]:
                full = full.reshape(m["shape"])
            device = like.device if isinstance(like, torch.Tensor) and like.device.type != "meta" else "cpu"
            leaves.append(_from_numpy(full, m["dtype"], device))
        return _rebuild(tree_like, iter(leaves)), meta.get("extra", {})
