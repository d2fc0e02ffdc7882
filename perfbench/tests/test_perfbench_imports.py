"""No module that the benchmark runs has JAX or the JAX package ``repro`` as
its top-level name (the part before the first dot, whole: ``repro_torch``
is the program), by the imports written in its files and by what a tiny
run leaves in ``sys.modules``."""
import ast
import subprocess
import sys

from harness import spec as specs

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_file_of_the_benchmark_imports_jax_or_repro():
    for path in specs.BENCH_DIR.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module and not node.level else [])
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_a_run_loads_no_jax_or_repro():
    code = f"""
import sys
sys.path[:0] = [{str(specs.BENCH_DIR)!r}, {str(specs.BENCH_DIR / 'tests')!r}]
import run, job, limits
from conftest import tiny_spec
from harness import cell
res = cell.run(tiny_spec("granite-train-4k"), 3, 0.2, True, "cpu")
res = cell.run(tiny_spec("resnet50-naive-x7", jobs=1), 3, 0.2, False, "cpu")
import boot
print(sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}))
print("repro_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(specs.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["[]", "True"]

