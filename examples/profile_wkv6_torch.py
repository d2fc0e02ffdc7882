"""Variants of the WKV6 kernel on one NVIDIA GPU: where its time goes, and
whether ``chip_smoke.py``'s checks catch a planted fault.

Times ``kernels.rwkv6_scan.wkv6_scan`` (CUDA-event medians, ``chip_smoke.gpu_ms``)
at rwkv6-1.6b's prefill shape, r/k/v (8, 2048, 32, 64) bf16, and at one long
sequence, (1, 32768, 32, 64), in variants of ``csrc/wkv6_scan.cu`` that each
take one part of the work out:

  full        the kernel as it is
  noexp       the pairwise scores without their exp (the exponent kept as the factor)
  noscores    no pairwise scores at all
  noproducts  none of the three products: scores.v, (r e^{clw_ex}).S, the state update
  source      with ``--source FILE``, that file in place of the kernel (an
              earlier version of it, say, to time against the current one)

Every variant but ``full`` computes wrong results: these are timings only.
They run in turns, twice over, so that drift between turns shows.

One more variant is checked instead of timed:

  plant       the state not decayed at the end of each chunk (e^{clw_C} taken
              as 1). It runs ``chip_smoke.wkv6_case`` at the prefill shape, at
              the model's slow decay and at a ragged shape, then rwkv6-1.6b's
              serving check (``chip_smoke.phase_serve``), and prints what each
              check found; every one of them should fail.

Each variant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` under
``build/wkv6_profile/<name>/``, built and run in a process of its own.

    PYTHONPATH=src python examples/profile_wkv6_torch.py [--variants full noexp ... plant] [--source FILE]

Prints one JSON line per variant and turn (per check for ``plant``).
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("src/repro_torch/kernels/csrc/wkv6_scan.cu")

# each edit is (pattern, replacement) and must match exactly once
EDITS = {
    "full": [],
    "noexp": [(r"ex2\(fminf\(cx\[a\] - cs\[s\], 0\.f\)\)", "(cx[a] - cs[s])")],
    "noscores": [(r"kk < K; \+\+kk\) \{\n(\s*)const float\* rr", r"kk < 0; ++kk) {\n\1const float* rr")],
    "noproducts": [
        (r"s < tA \+ 2; \+\+s\)", "s < 0; ++s)"),
        (r"s < 64 - tA; \+\+s\)", "s < 0; ++s)"),
        (r"kk < K; \+\+kk\) \{\n(\s*)float sv", r"kk < 0; ++kk) {\n\1float sv"),
        (r"s < C; \+\+s\)", "s < 0; ++s)"),
    ],
    "plant": [(r"const float dk = ex2\(clast\[kk\]\);", "const float dk = 1.f;")],
}
CHECKED = {"plant"}  # variants run through the checks instead of the timer


def make_copy(name: str, text: str) -> Path:
    dst = ROOT / "build" / "wkv6_profile" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / KERNEL).write_text(text)
    return dst


def variant_text(name: str, source: str) -> str:
    text = source
    for pattern, repl in EDITS[name]:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise SystemExit(f"variant {name}: {pattern!r} matched {n} times, not once")
    return text


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time the two shapes."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as c

    c.phase_build()
    gen = torch.Generator(device=c.DEV).manual_seed(5)
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for key, (B, T) in (("main_ms", (c.BATCH, c.PROMPT)), ("long_ms", (1, c.WKV_LONG_T))):
        args = c.wkv6_inputs(gen, B, T, 32)
        out[key] = c.gpu_ms(lambda: c.rk.wkv6_scan(*args), iters=10)
        del args
    print(json.dumps(out), flush=True)


def check_here(name: str) -> None:
    """In a variant's copy: build its kernels and run chip_smoke's K5 and
    rwkv6 serving checks on them, printing whether each passed or what it found."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as c

    def report(check: str, fn) -> None:
        try:
            fn()
            found = "passed"
        except AssertionError as e:
            found = f"failed: {e}"
        print(json.dumps({"variant": name, "check": check, "found": found}), flush=True)

    c.phase_build()
    cfg = c.get_config(c.RWKV_ARCH)
    gen = torch.Generator(device=c.DEV).manual_seed(4)
    for B, T, H, kw in ((c.BATCH, c.PROMPT, 32, {}), (c.BATCH, c.PROMPT, 32, {"state": True, "decay": "model"}),
                        (2, 100, 4, {"state": True})):
        report(f"wkv6_case B{B} T{T} H{H} {kw}", lambda: c.wkv6_case(gen, B, T, H, **kw))
    L, d, K = cfg.n_layers, cfg.d_model, cfg.ssm.head_dim
    report("phase_serve rwkv6-1.6b", lambda: c.phase_serve(
        cfg, {"wkv6_scan": c.rk}, {"wkv6_scan": L}, c.torch_wkv_path,
        {"wkv": (L, c.BATCH, d // K, K, K), "tm_x": (L, c.BATCH, d), "cm_x": (L, c.BATCH, d)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=["full", "noexp", "noscores", "noproducts"],
                    choices=sorted(EDITS))
    ap.add_argument("--source", type=Path, help="a wkv6_scan.cu to time as the variant 'source'")
    ap.add_argument("--time-here", help=argparse.SUPPRESS)
    ap.add_argument("--check-here", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_here:
        time_here(args.time_here)
        return
    if args.check_here:
        check_here(args.check_here)
        return

    current = (ROOT / KERNEL).read_text()
    copies = {name: make_copy(name, variant_text(name, current)) for name in args.variants}
    if args.source:
        copies["source"] = make_copy("source", args.source.read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    this = str(Path(__file__).resolve())
    for name in CHECKED & set(copies):
        subprocess.run([sys.executable, this, "--check-here", name], cwd=copies.pop(name), check=True)
    order = list(copies)
    for turn in range(2):
        for name in order if turn % 2 == 0 else order[::-1]:
            subprocess.run([sys.executable, this, "--time-here", name], cwd=copies[name], check=True)


if __name__ == "__main__":
    main()
