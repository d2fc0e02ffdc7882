"""Variants of the decode-attention kernel (K4) on one NVIDIA GPU: where its
time goes, how it compares with an earlier version, and whether
``chip_smoke.py``'s checks catch a planted fault.

Timed variants (``chip_smoke.gpu_ms`` of K4 beside one
``F.scaled_dot_product_attention`` call on the same work, bf16, each launch on
the next of enough layers' caches that it finds its cache cold, as
``chip_smoke.phase_decode`` times it) at three shapes: ``serve``, q (8,32,64),
caches (8,2080,8,64), kv_len 2064; ``batch1``, the same at batch 1; ``small``,
q (1,16,64), caches (1,4096,2,64), kv_len 4096:

  full            the kernel as it is
  max8            clusters of at most 8 blocks (the portable size)
  split4, split8  the split aiming at 2 and 4 blocks an SM instead of 1;
                  split1 no cluster (one block a sweep)
  stages2         a ring of 2 stages instead of 3
  rows128         splits of at least 128 cache rows instead of 256
  onepart         p.v from p rounded to 16 bits alone (no products of what
                  the rounding left)
  nocompute       the tiles are loaded and released, nothing computed
  nocombine       without the cluster's combine and its two barriers
  stream          neither: the cache's stream alone

Every variant from onepart on computes other results than the kernel: timings
only. Checked variants, run through the checks instead of the timer:

  sound           the kernel as it is
  drop_split      the combine leaves out the partial of the cluster's last block

Each runs ``chip_smoke.phase_decode`` (K4 against its plain version at the
serving shape and the ragged ones) and prints what it found. Copies, earlier
versions (``--source``, ``--tree``) and turns as ``kernel_variants`` sets out.

    PYTHONPATH=src python examples/profile_decode_attention_torch.py [--variants full ...] [--tree DIR ...]

Prints one JSON line per timed variant and turn, and per checked variant.
"""
import json
import math

import kernel_variants as kv

KERNEL = kv.CSRC / "decode_attention.cu"
WRAPPER = kv.PKG / "kernels/decode_attention.py"

NOCOMPUTE = (r"^(    // s = q\.k\^T over the warp's 16 rows: two n-tiles of 8 rows\n)",
             "    if (i >= 0) {\n      __syncthreads();\n      if (tid == 0 && i + STAGES < n_t) issue(i + STAGES);\n"
             "      continue;\n    }\n\\1")
NOCOMBINE = [(r"^  cluster\.sync\(\);\n  for \(int idx = rank \* NTHREADS \+ tid; idx < HEADS \* D;",
              "  for (int idx = rank * NTHREADS + tid; idx < 0;"),
             (r"^  cluster\.sync\(\);  // no block leaves", "  // no block leaves")]
EDITS = {
    "full": [],
    "max8": [(WRAPPER, r"^MAX_SPLITS = 16$", "MAX_SPLITS = 8")],
    "split4": [(WRAPPER, r"^BLOCKS_PER_SM = 1$", "BLOCKS_PER_SM = 2")],
    "split8": [(WRAPPER, r"^BLOCKS_PER_SM = 1$", "BLOCKS_PER_SM = 4")],
    "split1": [(WRAPPER, r"^MAX_SPLITS = 16$", "MAX_SPLITS = 1")],
    "stages2": [(r"^constexpr int STAGES = 3;$", "constexpr int STAGES = 2;")],
    "onepart": [(r"for \(int i = NP - 1; i >= 0; --i\)", "for (int i = 0; i >= 0; --i)")],
    "rows128": [(WRAPPER, r"^MIN_ROWS_PER_SPLIT = 256$", "MIN_ROWS_PER_SPLIT = 128")],
    "nocompute": [NOCOMPUTE],
    "nocombine": NOCOMBINE,
    "stream": [NOCOMPUTE, *NOCOMBINE],
    "sound": [],
    "drop_split": [(r"if \(j < CL\) \{\n        const float w", "if (j < CL - 1) {\n        const float w")],
}
CHECKED = {"sound", "drop_split"}
# (label, B, H, KVH, D, Smax, kv_len); the serving shape's come from chip_smoke
SMALL = ("small", 1, 16, 2, 64, 4096, 4096)
COLD_BYTES = 256 << 20  # the caches a timing cycles over: five times the 50 MB L2


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time K4 and the library call."""
    c = kv.chip_smoke()
    import torch
    import torch.nn.functional as F

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    smax, kv_n = c.PROMPT + c.NEW, c.PROMPT + c.NEW // 2
    gen = torch.Generator(device=c.DEV).manual_seed(6)
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for label, B, Hh, KVHh, Dh, Smax, n in (("serve", c.BATCH, H, KVH, D, smax, kv_n),
                                            ("batch1", 1, H, KVH, D, smax, kv_n), SMALL):
        layers = max(8, math.ceil(COLD_BYTES / (2 * B * Smax * KVHh * Dh * 2)))
        q = c.randn(gen, (B, Hh, Dh))
        kc, vc = c.randn(gen, (layers, B, Smax, KVHh, Dh)), c.randn(gen, (layers, B, Smax, KVHh, Dh))
        kv_len = torch.tensor([n], dtype=torch.int32, device=c.DEV)
        state = {"i": 0}

        def cycle(fn):
            def run():
                i = state["i"] = (state["i"] + 1) % layers
                return fn(kc[i], vc[i])
            return run

        q4 = q[:, :, None, :]
        out[f"{label}_splits"] = c.da.n_splits(B, KVHh, Hh // KVHh, Smax, c._build.sm_count(0))
        out[f"{label}_ms"] = c.gpu_ms(cycle(lambda a, b: c.da.decode_attention(q, a, b, kv_len)), iters=40)
        out[f"{label}_library_ms"] = c.gpu_ms(cycle(lambda a, b: F.scaled_dot_product_attention(
            q4, a[:, :n].permute(0, 2, 1, 3), b[:, :n].permute(0, 2, 1, 3), enable_gqa=True)), iters=40)
        del q, kc, vc
    print(json.dumps(out), flush=True)


def check_here(name: str) -> None:
    """In a variant's copy: build its kernels and run chip_smoke's K4 check."""
    c = kv.chip_smoke()
    c.phase_build(strict=False)
    kv.report(name, "phase_decode", lambda: c.phase_decode(c.get_config(c.ARCH)))


if __name__ == "__main__":
    kv.main(__doc__, kernel=KERNEL, edits=EDITS, checked=CHECKED, default=["full"],
            time_here=time_here, check_here=check_here)
