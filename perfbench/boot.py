"""Paths and caches of a benchmark process; imported first by ``run.py`` and
``job.py``.

Puts the harness (this directory) and the program (``src/`` of the
checkout) on ``sys.path``, and keeps every build and kernel cache of the
program at a fixed place inside the checkout, so that only a cell's first
run in a checkout builds anything: the program's nvcc libraries go to
``build/`` (``repro_torch.kernels._build``), PyTorch's extension builds and
Triton's cache below it.
"""
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

for path in (str(ROOT / "src"), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

#: top-level module names that no benchmark process may hold: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
