"""Build and load the CUDA kernels of this package.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds. ``load(name)`` compiles the source
for ``sm_90a`` into a shared library at first use and opens it with
``ctypes``; all sources are compiled together, one ``nvcc`` process each, so
the first kernel's launch pays for the whole set once. Libraries are keyed by
a hash of the source, of every header of ``csrc/`` it includes (directly or
through another header) and of the flags: an edit of either rebuilds, an
unchanged source is reused. Nothing is built when the module is imported,
and a machine without ``nvcc`` can import it; only the first launch needs
the compiler.

The build directory is ``build/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: what the negative codes of ``csrc/hopper.cuh`` that a launch returns mean
LAUNCH_ERRORS = {
    -1: "no kernel for this head_dim or type",
    -2: "the CUDA driver has no cuTensorMapEncodeTiled",
    -3: "the CUDA driver refused a tensor map of these tensors",
    -4: "a tile plan the kernels cannot take",
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc processes started since import: stays put while libraries are reused
n_compiles = 0
#: what ``ptxas -v`` said of each source at its last compile (registers, shared memory, spills)
ptxas_log: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(str(Path(os.environ[var]) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are compiled from source at first use"
    )


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def headers(src: Path) -> List[Path]:
    """The headers that ``src`` includes with quotes, directly or through
    another header, each once, in the order first met; a quoted include
    resolves beside the file that names it, as ``nvcc`` resolves it."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_text()):
            path = (cur.parent / name).resolve()
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in headers(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library; returns name -> path."""
    global n_compiles
    targets = {src.stem: (src, _target(src)) for src in sources()}
    todo: List[Tuple[Path, Path]] = [
        (src, out) for src, out in targets.values() if not out.exists()
    ]
    if todo:
        nvcc = find_nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            n_compiles += 1
            procs.append((src, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for src, out, tmp, cmd, proc in procs:
            log, _ = proc.communicate()
            ptxas_log[src.stem] = log
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees a half-written library
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {name: out for name, (_, out) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(str(paths[name]))
        return _libs[name]


def count_launch(namespace: Dict[str, int], name: str) -> None:
    """Adds one to the launch counter ``name`` of a wrapper module (its
    ``globals()``) under one lock: jobs that launch from threads of their own
    (``examples/collocated_hparam_sweep_torch.py``) lose no count, as an
    unguarded ``+= 1`` can."""
    with _count_lock:
        namespace[name] += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once: the
    wrappers split their work so that every SM gets a block."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
