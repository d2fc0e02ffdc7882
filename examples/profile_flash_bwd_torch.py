"""Variants of the flash-attention backward kernels on one NVIDIA GPU: where
their time goes, and whether ``chip_smoke.py``'s checks catch a planted fault.

Each variant is a copy of ``csrc/flash_attention_bwd.cu`` with one edit by a
regular expression, built and run in a process of its own. Timed variants
(``chip_smoke.gpu_ms`` of each kernel at the training shape, q/do
(2,8,4096,4,64), k/v (2,8,4096,64), bf16, causal; in turns, twice over):

  full            the kernels as they are
  noexp           p without its exp2 (the exponent kept as p), both kernels
  nosecond        without the products that take p or ds from registers:
                  dq += ds.k in K3, dv += p^T.do and dk += ds^T.q in K2 (p
                  and ds are still computed and packed)
  <stem>          with ``--source FILE ...``, each file in place of the kernels
                  (an earlier version, say, to time against the current one),
                  named by its stem

Every variant but ``full`` computes wrong results: these are timings only.

Checked variants, each with one planted fault:

  dq_skip_diag    the dq kernel (K3) skips its diagonal KV tile: the last tile
                  of its causal sweep adds nothing to dq
  dkv_skip_first  the dk/dv kernel (K2) skips the first q tile of its sweep

Each runs ``chip_smoke.flash_bwd_case`` at the training shape and at two
ragged causal shapes, then ``chip_smoke.one_step`` (granite-3-2b at full
size, one step's loss and gradients against the non-kernel path). It prints
what each check found: every one should fail. ``one_step`` prints its
readings (the gradients' relative L2 errors) before it holds them to their
limits, so the output also gives the faults' readings from which
``TOL_GRAD_ATTN`` and ``TOL_GRAD_OTHER`` are set. ``sound`` runs the same
checks on the kernels as they are.

Each copy of ``src/repro_torch`` and ``chip_smoke.py`` lives under
``build/flash_bwd_profile/<name>/``.

    PYTHONPATH=src python examples/profile_flash_bwd_torch.py [--variants full noexp ... dq_skip_diag]

Prints one JSON line per timed variant and turn, and per checked variant and check.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention_bwd.cu")

# each edit is (pattern, replacement) and must match exactly once
EDITS = {
    "full": [],
    "noexp": [(r'asm\("ex2\.approx\.ftz\.f32 %0, %1;\\n" : "=f"\(y\) : "f"\(x\)\);', "y = x;")],
    "nosecond": [(r"kk < NK / 16; \+\+kk\) mma_rs<T, D>\(dq,", "kk < 0; ++kk) mma_rs<T, D>(dq,"),
                 (r"kk < 4; \+\+kk\) mma_rs<T, D>\(dv,", "kk < 0; ++kk) mma_rs<T, D>(dv,"),
                 (r"kk < 4; \+\+kk\) mma_rs<T, D>\(dk,", "kk < 0; ++kk) mma_rs<T, D>(dk,")],
    "sound": [],
    "dq_skip_diag": [(r"const bool dead = wg_rows <= 0 \|\| \(p\.causal && kv0 > wg_last\);",
                      "const bool dead = wg_rows <= 0 || (p.causal && (kv0 > wg_last || it == n_kt - 1));")],
    "dkv_skip_first": [(r"const bool dead = p\.causal && first \+ tp\.P - 1 < kv_w;",
                        "const bool dead = it == 0 || (p.causal && first + tp.P - 1 < kv_w);")],
}


def make_copy(name: str, text: str) -> Path:
    dst = ROOT / "build" / "flash_bwd_profile" / name
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


CHECKED = {"sound", "dq_skip_diag", "dkv_skip_first"}  # run through the checks instead of the timer


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time both at the training shape."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as c

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    B, S, H, KVH, D = c.TRAIN_BATCH, c.TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=c.DEV).manual_seed(5)
    q, do = c.randn(gen, (B, S, H, D)), c.randn(gen, (B, S, H, D))
    k, v = c.randn(gen, (B, S, KVH, D)), c.randn(gen, (B, S, KVH, D))
    qf, kf, vf, dof = c.ops._fold(q, KVH), c.ops._kv_fold(k), c.ops._kv_fold(v), c.ops._fold(do, KVH)
    kw = dict(causal=True, scale=D**-0.5)
    o, lse = c.fa.flash_attention_fwd(qf, kf, vf, **kw)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    out["dq_ms"] = c.gpu_ms(lambda: c.fa.launch_bwd_dq(qf, kf, vf, o, dof, lse, delta, dq, **kw), iters=10)
    out["dkv_ms"] = c.gpu_ms(lambda: c.fa.launch_bwd_dkv(qf, kf, vf, dof, lse, delta, dk, dv, **kw), iters=10)
    print(json.dumps(out), flush=True)


def check_here(name: str) -> None:
    """In a variant's copy: build its kernels and run chip_smoke's backward and
    training checks on them, printing whether each passed or what it found."""
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

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=c.DEV).manual_seed(3)
    for B, S, Hh, KVHh, Dh, kw in ((c.TRAIN_BATCH, c.TRAIN_SEQ, H, KVH, D, {"by_rows": True}),
                                   (2, 100, 6, 2, 64, {}), (2, 100, 8, 2, 64, {"q_offset": 64})):
        report(f"flash_bwd_case B{B} S{S} H{Hh} KVH{KVHh} D{Dh} causal {kw}",
               lambda: c.flash_bwd_case(gen, B, S, S, Hh, KVHh, Dh, True, **kw))
        torch.cuda.empty_cache()
    report("one_step granite-3-2b", lambda: c.one_step(cfg, c.build_model(cfg), c.make_plan(cfg, None)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=["full", "noexp", "nosecond"], choices=sorted(EDITS))
    ap.add_argument("--source", type=Path, nargs="+", default=[],
                    help="other flash_attention_bwd.cu files to time, each as the variant named by its stem")
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
    for path in args.source:
        copies[path.stem] = make_copy(path.stem, path.read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    this = str(Path(__file__).resolve())
    for name in [n for n in copies if n in CHECKED]:
        subprocess.run([sys.executable, this, "--check-here", name], cwd=copies.pop(name), check=True)
    order = list(copies)
    for turn in range(2):
        for name in order if turn % 2 == 0 else order[::-1]:
            subprocess.run([sys.executable, this, "--time-here", name], cwd=copies[name], check=True)


if __name__ == "__main__":
    main()
