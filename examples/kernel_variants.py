"""The harness of the kernel profiling examples (``profile_*_torch.py``).

A variant is a copy of the package ``src/repro_torch`` and of ``chip_smoke.py``
under ``build/<script>/<variant>/`` with edits by regular expressions, built and
run in a process of its own. Checked variants run ``chip_smoke.py``'s checks
(the script's ``check_here``); the others are timed (its ``time_here``) in
turns, twice over, the second turn in reverse order so that drift between
turns shows. Two kinds of earlier version take a variant's place:

  --source FILE ...   each file in place of the script's kernel source,
                      timed as the variant named by the file's stem
  --tree DIR ...      the package under DIR/src/repro_torch (``git archive
                      <rev> src/repro_torch`` unpacked in DIR), with its own
                      wrapper and kernels, timed as the variant named by DIR

The first line of output is the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = Path("src/repro_torch")
CSRC = PKG / "kernels/csrc"
HEADER = CSRC / "hopper.cuh"


def make_copy(dst: Path, files: dict, tree: Path = ROOT) -> Path:
    """A copy of the package under ``tree`` and of chip_smoke.py in ``dst``,
    with ``files`` (path -> text) in place."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / PKG, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for path, text in files.items():
        (dst / path).write_text(text)
    return dst


def edited(name: str, edits: list, kernel: Path) -> dict:
    """The files that ``edits`` change, path -> text. Each edit is (pattern,
    replacement) in ``kernel``, or (file, pattern, replacement), and must match
    exactly once."""
    files = {}
    for edit in edits:
        path, pattern, repl = edit if len(edit) == 3 else (kernel, *edit)
        text = files.get(path, (ROOT / path).read_text())
        files[path], n = re.subn(pattern, repl, text, flags=re.MULTILINE)
        if n != 1:
            raise SystemExit(f"variant {name}: {pattern!r} matched {n} times in {path}, not once")
    return files


def chip_smoke():
    """``chip_smoke`` of the variant's copy (the working directory), imported."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as c

    return c


def report(variant: str, check: str, fn) -> None:
    """Runs one check and prints whether it passed or what it found."""
    try:
        fn()
        found = "passed"
    except AssertionError as e:
        found = f"failed: {e}"
    print(json.dumps({"variant": variant, "check": check, "found": found}), flush=True)


def main(doc: str, *, kernel: Path, edits: dict, checked: set, default: list, time_here, check_here) -> None:
    """The command line of a profiling script: builds the copies and runs the
    checked variants through ``check_here(name)``, then the others through
    ``time_here(name)``, each in a process of its own."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=default, choices=sorted(edits))
    ap.add_argument("--source", type=Path, nargs="+", default=[],
                    help=f"other {kernel.name} files to time, each as the variant named by its stem")
    ap.add_argument("--tree", type=Path, nargs="+", default=[],
                    help="directories DIR with an earlier package in DIR/src/repro_torch, each timed as the "
                         "variant named by DIR")
    ap.add_argument("--time-here", help=argparse.SUPPRESS)
    ap.add_argument("--check-here", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_here:
        time_here(args.time_here)
        return
    if args.check_here:
        check_here(args.check_here)
        return

    script = Path(sys.argv[0]).resolve()
    area = ROOT / "build" / script.stem
    copies = {name: make_copy(area / name, edited(name, edits[name], kernel)) for name in args.variants}
    for path in args.source:
        copies[path.stem] = make_copy(area / path.stem, {kernel: path.read_text()})
    for tree in args.tree:
        copies[tree.name] = make_copy(area / tree.name, {}, tree.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for name in [n for n in copies if n in checked]:
        subprocess.run([sys.executable, str(script), "--check-here", name], cwd=copies.pop(name), check=True)
    order = list(copies)
    for turn in range(2):
        for name in order if turn % 2 == 0 else order[::-1]:
            subprocess.run([sys.executable, str(script), "--time-here", name], cwd=copies[name], check=True)
