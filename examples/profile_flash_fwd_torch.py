"""Variants of the flash-attention forward kernel (K1) on one NVIDIA GPU: where
its time goes, how it compares with an earlier version, and whether
``chip_smoke.py``'s checks catch a planted fault.

Each variant edits ``csrc/flash_attention_fwd.cu`` (or the header
``csrc/hopper.cuh`` it includes) by regular expressions. Timed variants
(``chip_smoke.gpu_ms`` of K1 at the serving shape, q (8,8,2048,4,64), k/v
(8,8,2048,64), at the training shape, q (2,8,4096,4,64), and at zamba2-7b's
serving shape at head_dim 112, q (8,32,2048,1,112), bf16, causal, beside one
``F.scaled_dot_product_attention`` call on the same work; in turns, twice
over):

  full            the kernel as it is
  noexp           p without its exp2 (the exponent kept as p)
  nopv            without the products o += p.v (p is still computed and packed)
  nc2             two consumer warpgroups (128 q rows) a block at D = 64
                  instead of three
  noturns         the consumer warpgroups issue their products without
                  taking turns
  stages4         a ring of 4 (K, V) stages instead of 3 (at D = 64, 112 and 128)
  nc2_112         two consumer warpgroups (128 q rows) a block at D = 112
                  instead of three, at 240 registers a consumer thread
  kv128_112       KV tiles of 128 rows at D = 112 instead of 64, in a ring of
                  2 stages (3 would not fit beside the q and o tiles)
  exp2fma         a quarter of the softmax's exp2 by a polynomial on the FMA
                  pipe instead of the SFU

Every variant but ``full``, ``nc2``, ``noturns``, ``stages4``, ``nc2_112``,
``kv128_112`` and ``exp2fma`` computes wrong results: these are timings only.
A variant's build is not strict: its ``build`` line gives each kernel's
registers and spills.

Checked variants, run through the checks instead of the timer:

  sound           the kernel as it is
  diag_plus_one   the causal mask lets every row see one key past the diagonal

Each runs ``chip_smoke.phase_flash`` (K1 against its plain version at the
serving shape and the ragged ones), serves granite-3-2b against the non-kernel
path (``chip_smoke.phase_serve``), trains one step of it
(``chip_smoke.one_step``: the backward kernels read K1's lse), and serves
deepseek-moe-16b against the spread of two non-kernel paths (its ``serve``
line's ``yardstick`` gives the readings from which ``chip_smoke.SPREAD_LIMIT``
is set), and prints what each check found. Copies, earlier versions (``--source``, ``--tree``)
and turns as ``kernel_variants`` sets out.

    PYTHONPATH=src python examples/profile_flash_fwd_torch.py [--variants full noexp ...] [--tree DIR ...]

Prints one JSON line per timed variant and turn, and per checked variant and check.
"""
import json

import kernel_variants as kv

KERNEL = kv.CSRC / "flash_attention_fwd.cu"

EDITS = {
    "full": [],
    "noexp": [(kv.HEADER, r'asm\("ex2\.approx\.ftz\.f32 %0, %1;\\n" : "=f"\(y\) : "f"\(x\)\);', "y = x;")],
    "nopv": [(r"kk < NK / 16; \+\+kk\) mma_rs<T, D>\(o,", "kk < 0; ++kk) mma_rs<T, D>(o,")],
    "nc2": [(r"return D == 64 \|\| D == 112 \? 3 : 2;", "return D == 112 ? 3 : 2;"),
            (kv.PKG / "kernels/flash_attention.py", r"return 192 if D in \(64, 112\) else 128",
             "return 192 if D == 112 else 128")],
    "noturns": [(r"^  if \(wg == NC - 1\) named_barrier_arrive\(2, 256\);\n", ""),
                (r"^      named_barrier\(2 \+ wg, 256\);\n", ""),
                (r"^      named_barrier_arrive\(2 \+ \(wg \+ 1\) % NC, 256\);\n", ""),
                (r"^      if \(j >= 1\) \{\n        named_barrier\(2 \+ wg, 256\);\n"
                 r"        named_barrier_arrive\(2 \+ \(wg \+ 1\) % NC, 256\);\n      \}\n", "")],
    "stages4": [(r"return D == 160 \? 2 : 3;", "return D == 160 ? 2 : 4;")],
    "nc2_112": [(r"return D == 64 \|\| D == 112 \? 3 : 2;", "return D == 64 ? 3 : 2;"),
                (kv.PKG / "kernels/flash_attention.py", r"return 192 if D in \(64, 112\) else 128",
                 "return 192 if D == 64 else 128")],
    "kv128_112": [(r"return D == 64 \? 128 : 64;", "return D == 64 || D == 112 ? 128 : 64;"),
                  (r"return D == 160 \? 2 : 3;", "return D == 160 || D == 112 ? 2 : 3;")],
    # a quarter of the softmax's exp2 on the FMA pipe: 2^x = 2^round(x) * 2^f,
    # f in [-0.5, 0.5], 2^f by its degree-5 Taylor polynomial (relative error
    # about 2.4e-6), 2^round(x) added into the exponent bits
    "exp2fma": [(r"^(// p = exp\(scale \* \(s - m_new\)\) of one tile in place)",
                 "__device__ __forceinline__ float exp2_fma(float x) {\n"
                 "  x = fmaxf(x, -125.f);\n"
                 "  const float j = x + 12582912.f;\n"
                 "  const float f = x - (j - 12582912.f);\n"
                 "  float p = fmaf(f, 1.3333558e-3f, 9.6181291e-3f);\n"
                 "  p = fmaf(p, f, 5.5504109e-2f);\n"
                 "  p = fmaf(p, f, 2.4022651e-1f);\n"
                 "  p = fmaf(p, f, 6.9314718e-1f);\n"
                 "  p = fmaf(p, f, 1.f);\n"
                 "  return __int_as_float(__float_as_int(p) + (__float_as_int(j) << 23));\n"
                 "}\n\n\\1"),
                (r"s\[4 \* j \+ 2 \* i\] = exp2_ftz\(fmaf\(s\[4 \* j \+ 2 \* i\], c, off\)\);",
                 "s[4 * j + 2 * i] = (j & 3) == 3 ? exp2_fma(fmaf(s[4 * j + 2 * i], c, off))"
                 " : exp2_ftz(fmaf(s[4 * j + 2 * i], c, off));"),
                (r"s\[4 \* j \+ 2 \* i \+ 1\] = exp2_ftz\(fmaf\(s\[4 \* j \+ 2 \* i \+ 1\], c, off\)\);",
                 "s[4 * j + 2 * i + 1] = (j & 3) == 3 ? exp2_fma(fmaf(s[4 * j + 2 * i + 1], c, off))"
                 " : exp2_ftz(fmaf(s[4 * j + 2 * i + 1], c, off));")],
    "sound": [],
    "diag_plus_one": [(r"kv_last\[i\] = p\.causal \? min\(p\.Skv, p\.q_offset \+ pos\[i\] \+ 1\) - 1",
                       "kv_last[i] = p.causal ? min(p.Skv, p.q_offset + pos[i] + 2) - 1")],
}
CHECKED = {"sound", "diag_plus_one"}


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time K1 and the library call."""
    c = kv.chip_smoke()
    import torch
    import torch.nn.functional as F

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=c.DEV).manual_seed(5)
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    zamba = c.get_config(c.ZAMBA_ARCH)
    for label, B, S, H, KVH, D in (("serve", c.BATCH, c.PROMPT, H, KVH, D),
                                   ("train", c.TRAIN_BATCH, c.TRAIN_SEQ, H, KVH, D),
                                   ("serve_d112", c.BATCH, c.PROMPT, zamba.n_heads, zamba.n_kv_heads,
                                    zamba.resolved_head_dim)):
        q, k, v = c.randn(gen, (B, S, H, D)), c.randn(gen, (B, S, KVH, D)), c.randn(gen, (B, S, KVH, D))
        qf, kf, vf = c.ops._fold(q, KVH), c.ops._kv_fold(k), c.ops._kv_fold(v)
        out[f"{label}_ms"] = c.gpu_ms(lambda: c.fa.flash_attention_fwd(qf, kf, vf, causal=True, scale=D**-0.5),
                                      iters=10)
        ql, kl, vl = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        out[f"{label}_library_ms"] = c.gpu_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True), iters=10)
        del q, k, v, qf, kf, vf, ql, kl, vl
    print(json.dumps(out), flush=True)


def check_here(name: str) -> None:
    """In a variant's copy: build its kernels and run chip_smoke's K1 check,
    granite serving and one training step on them."""
    c = kv.chip_smoke()
    import torch

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    kv.report(name, "phase_flash", lambda: c.phase_flash(cfg))
    torch.cuda.empty_cache()
    kv.report(name, "serve granite-3-2b", lambda: c.phase_serve(
        cfg, {"flash_attention_fwd": c.fa, "decode_attention": c.da},
        {"flash_attention_fwd": L, "decode_attention": L * (c.NEW - 1)}, c.torch_attention_path,
        {n: (L, c.BATCH, c.PROMPT + c.NEW, kvh, hd) for n in ("k", "v")}))
    torch.cuda.empty_cache()
    kv.report(name, "one_step granite-3-2b", lambda: c.one_step(cfg, c.build_model(cfg), c.make_plan(cfg, None)))
    torch.cuda.empty_cache()
    # deepseek-moe-16b, held to the spread of two non-kernel paths (chip_smoke.SPREAD_LIMIT)
    ds = c.get_config(c.DEEPSEEK_ARCH)
    k1, k4 = c.SERVE_LAUNCHES[c.DEEPSEEK_ARCH]
    shapes = {n: shape for n, (shape, _) in c.build_model(ds).cache_spec(c.BATCH, c.PROMPT + c.NEW).items()}
    kv.report(name, "serve deepseek-moe-16b", lambda: c.phase_serve(
        ds, {"flash_attention_fwd": c.fa, "decode_attention": c.da},
        {"flash_attention_fwd": k1, "decode_attention": k4}, c.torch_attention_path, shapes,
        yardstick=c.f32_attention_path))


if __name__ == "__main__":
    kv.main(__doc__, kernel=KERNEL, edits=EDITS, checked=CHECKED, default=["full", "noexp", "nopv"],
            time_here=time_here, check_here=check_here)
