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

Every variant but ``full`` computes wrong results: these are timings only.

One more variant is checked instead of timed:

  plant       the state not decayed at the end of each chunk (e^{clw_C} taken
              as 1). It runs ``chip_smoke.wkv6_case`` at the prefill shape, at
              the model's slow decay and at a ragged shape, then rwkv6-1.6b's
              serving check (``chip_smoke.phase_serve``), and prints what each
              check found; every one of them should fail.

Copies, earlier versions (``--source``, ``--tree``) and turns as
``kernel_variants`` sets out.

    PYTHONPATH=src python examples/profile_wkv6_torch.py [--variants full noexp ... plant] [--source FILE ...]

Prints one JSON line per variant and turn (per check for ``plant``).
"""
import json

import kernel_variants as kv

KERNEL = kv.CSRC / "wkv6_scan.cu"

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


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time the two shapes."""
    c = kv.chip_smoke()
    import torch

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
    rwkv6 serving checks on them."""
    c = kv.chip_smoke()
    import torch

    c.phase_build()
    cfg = c.get_config(c.RWKV_ARCH)
    gen = torch.Generator(device=c.DEV).manual_seed(4)
    for B, T, H, kw in ((c.BATCH, c.PROMPT, 32, {}), (c.BATCH, c.PROMPT, 32, {"state": True, "decay": "model"}),
                        (2, 100, 4, {"state": True})):
        kv.report(name, f"wkv6_case B{B} T{T} H{H} {kw}", lambda: c.wkv6_case(gen, B, T, H, **kw))
    L, d, K = cfg.n_layers, cfg.d_model, cfg.ssm.head_dim
    kv.report(name, "phase_serve rwkv6-1.6b", lambda: c.phase_serve(
        cfg, {"wkv6_scan": c.rk}, {"wkv6_scan": L}, c.torch_wkv_path,
        {"wkv": (L, c.BATCH, d // K, K, K), "tm_x": (L, c.BATCH, d), "cm_x": (L, c.BATCH, d)}))


if __name__ == "__main__":
    kv.main(__doc__, kernel=KERNEL, edits=EDITS, checked=CHECKED, default=["full", "noexp", "noscores", "noproducts"],
            time_here=time_here, check_here=check_here)
