"""Variants of the WKV6 kernel on one NVIDIA GPU: where its time goes, and
whether ``chip_smoke.py``'s checks catch a planted fault.

Times ``kernels.rwkv6_scan.wkv6_scan`` (CUDA-event medians, ``chip_smoke.gpu_ms``)
at rwkv6-1.6b's prefill shape, r/k/v (8, 2048, 32, 64) bf16, and at one long
sequence, (1, 32768, 32, 64), in variants of ``csrc/wkv6_scan.cu`` that each
take one part of the work out:

  full        the kernel as it is
  noexp       the diagonal blocks' scores without their exp (the exponent kept as the factor)
  nodiag      no diagonal blocks (nor the bonus)
  nooffdiag   no off-diagonal blocks of the scores
  noproducts  no tensor-core product at all (what only feeds them goes too)
  stream      each chunk loaded and released, nothing computed

Every variant but ``full`` computes wrong results: these are timings only.

Two more variants plant a fault and are checked instead of timed:

  plant       the state not decayed at the end of each chunk (2^{clw_C}
              taken as 1)
  refpoint    the r factor of every off-diagonal block (i, j) decayed to the
              reference point of its own sub-chunk, b_i, instead of b_j

Each runs ``chip_smoke.wkv6_case`` at the prefill shape, at the model's slow
decay, at a ragged shape and at -20 a token, then rwkv6-1.6b's serving checks
(``chip_smoke.phase_serve``: layer 0's K5 output on the run's own inputs
against float64, then the logits against the non-kernel path), and prints
what each check found; every one of them should fail, and ``sound`` (the
kernel as it is, checked) pass. The ``serve`` line printed before the
finding holds both checks' readings.

Copies, earlier versions (``--source``, ``--tree``) and turns as
``kernel_variants`` sets out; e.g. an earlier commit's kernel, by ``git archive
<rev> src/repro_torch | tar -x -C build/baseline/<name>`` and ``--tree
build/baseline/<name>``.

    PYTHONPATH=src python examples/profile_wkv6_torch.py [--variants full noexp ... plant] [--tree DIR ...]

Prints one JSON line per variant and turn (per check for the checked ones).
"""
import json

import kernel_variants as kv

KERNEL = kv.CSRC / "wkv6_scan.cu"

EDITS = {
    "full": [],
    "noexp": [(r"exp2_ftz\(\(on_a \? xa\[hf\]\[m\] : xb\[hf\]\[m\]\) - cs\[m\]\)",
               "((on_a ? xa[hf][m] : xb[hf][m]) - cs[m])")],
    "nodiag": [(r"for \(int e = 0; e < 15; \+\+e\) \{\n(\s*)const bool on_a", r"for (int e = 0; e < 0; ++e) {\n\1const bool on_a")],
    "nooffdiag": [(r"(for \(int ks = 0; ks )< K / 16(; \+\+ks\) \{\n\s*const int k0 = 16 \* ks \+ 2 \* q;\n\s*float2 xa\[4\];"
                   r"\n\s*#pragma unroll\n\s*for \(int f = 0; f < 4; \+\+f\) \{\n\s*const int t = ti)", r"\1< 0\2")],
    "noproducts": [(r"if \(i \+ j < NP\) mma16816", "if (false) mma16816")],
    "stream": [(r"(if \(ch \+ 1 < n_chunks\) load_chunk\(ch \+ 1\);\n\s*cp_async_commit\(\);)", r"\1\n    continue;")],
    "sound": [],
    "plant": [(r"const float d0 = exp2_ftz\(cl0\), d1 = exp2_ftz\(cl1\);", "const float d0 = 1.f, d1 = 1.f;")],
    "refpoint": [(r"(const float2 cx = cw2\(t - 1, kk\);\n\s*)const float2 bb = cw2\(bj, kk\);",
                  r"\1const float2 bb = cw2(ti + SUB - 1, kk);")],
}
CHECKED = {"sound", "plant", "refpoint"}  # variants run through the checks instead of the timer


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time the two shapes."""
    c = kv.chip_smoke()
    import torch

    c.phase_build(strict=False)  # variants without products, and earlier versions, have no HMMA
    gen = torch.Generator(device=c.DEV).manual_seed(5)
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for key, (B, T) in (("main_ms", (c.BATCH, c.PROMPT)), ("long_ms", (1, c.WKV_LONG_T))):
        args = c.wkv6_inputs(gen, B, T, 32)
        out[key] = c.gpu_ms(lambda: c.rk.wkv6_scan(*args), iters=10)
        del args
    print(json.dumps(out), flush=True)


def check_here(name: str) -> None:
    """In a variant's copy: build its kernels and run chip_smoke's K5 and
    rwkv6 serving checks on them."""
    c = kv.chip_smoke()
    import torch

    c.phase_build(strict=False)  # a planted fault may change the registers; chip_smoke.py holds the sound kernel
    cfg = c.get_config(c.RWKV_ARCH)
    gen = torch.Generator(device=c.DEV).manual_seed(4)
    for B, T, H, kw in ((c.BATCH, c.PROMPT, 32, {}), (c.BATCH, c.PROMPT, 32, {"state": True, "decay": "model"}),
                        (2, 100, 4, {"state": True}), (2, 256, 4, {"state": True, "decay": -20.0})):
        kv.report(name, f"wkv6_case B{B} T{T} H{H} {kw}", lambda: c.wkv6_case(gen, B, T, H, **kw))
    L, d, K = cfg.n_layers, cfg.d_model, cfg.ssm.head_dim
    kv.report(name, "phase_serve rwkv6-1.6b", lambda: c.phase_serve(
        cfg, {"wkv6_scan": c.rk}, {"wkv6_scan": L}, c.torch_wkv_path,
        {"wkv": (L, c.BATCH, d // K, K, K), "tm_x": (L, c.BATCH, d), "cm_x": (L, c.BATCH, d)}, c.wkv_probe))


if __name__ == "__main__":
    kv.main(__doc__, kernel=KERNEL, edits=EDITS, checked=CHECKED, default=["full", "noexp", "nodiag", "nooffdiag", "noproducts", "stream"],
            time_here=time_here, check_here=check_here)
