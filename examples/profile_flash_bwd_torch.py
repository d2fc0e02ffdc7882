"""Variants of the flash-attention backward kernels on one NVIDIA GPU: where
their time goes, and whether ``chip_smoke.py``'s checks catch a planted fault.

Each variant edits ``csrc/flash_attention_bwd.cu`` (or the header
``csrc/hopper.cuh`` it includes) by regular expressions. Timed variants
(``chip_smoke.gpu_ms`` of each kernel at the training shape, q/do
(2,8,4096,4,64), k/v (2,8,4096,64), bf16, causal; in turns, twice over):

  full            the kernels as they are
  noexp           p without its exp2 (the exponent kept as p), both kernels
                  (and every other exp2_ftz of the header)
  nosecond        without the products that take p or ds from registers:
                  dq += ds.k in K3, dv += p^T.do and dk += ds^T.q in K2 (p
                  and ds are still computed and packed; K2 at D = 64 and 128
                  only, the shape timed)

Every variant but ``full`` computes wrong results: these are timings only.

Checked variants, each with one planted fault:

  dq_skip_diag    the dq kernel (K3) skips its diagonal KV tile: the last tile
                  of its causal sweep adds nothing to dq
  dkv_skip_first  the dk/dv kernel (K2) skips the first q tile of its sweep

Each runs ``chip_smoke.flash_bwd_case`` at the training shape and at two
ragged causal shapes, then ``chip_smoke.one_step`` (granite-3-2b at full
size, one step's loss and gradients against the non-kernel path), then the
same at head_dim 160: the case at stablelm-12b's training shape and its
one-step check at full width and depth 2 (``chip_smoke.STABLELM_TOL``), then
the one-query-head-a-KV-head configs: the case at whisper-base's cross
attention in training (non-causal, 448 x 1500) and the one-step checks of
olmoe-1b-7b at full width and depth 2 (``chip_smoke.OLMOE_TOL``) and of
whisper-base at full size (``chip_smoke.WHISPER_TOL``). It prints
what each check found: every one should fail. ``one_step`` prints its
readings (the gradients' relative L2 errors) before it holds them to their
limits, so the output also gives the faults' readings from which
``TOL_GRAD_ATTN`` and ``TOL_GRAD_OTHER`` are set. ``sound`` runs the same
checks on the kernels as they are. Copies, earlier versions (``--source``,
``--tree``) and turns as ``kernel_variants`` sets out.

    PYTHONPATH=src python examples/profile_flash_bwd_torch.py [--variants full noexp ... dq_skip_diag]

Prints one JSON line per timed variant and turn, and per checked variant and check.
"""
import json

import kernel_variants as kv

KERNEL = kv.CSRC / "flash_attention_bwd.cu"
EXP2 = (r'asm\("ex2\.approx\.ftz\.f32 %0, %1;\\n" : "=f"\(y\) : "f"\(x\)\);', "y = x;")

EDITS = {
    "full": [],
    "noexp": [(kv.HEADER, *EXP2)],
    "nosecond": [(r"kk < NK / 16; \+\+kk\) mma_rs<T, D>\(dq,", "kk < 0; ++kk) mma_rs<T, D>(dq,"),
                 (r"^          for \(int kk = 0; kk < 4; \+\+kk\) mma_rs<T, D>\(acc, pf",
                  "          for (int kk = 0; kk < 0; ++kk) mma_rs<T, D>(acc, pf"),
                 (r"kk < 4; \+\+kk\) mma_rs<T, D>\(dk_acc,", "kk < 0; ++kk) mma_rs<T, D>(dk_acc,")],
    "sound": [],
    "dq_skip_diag": [(r"const bool dead = wg_rows <= 0 \|\| \(p\.causal && kv0 > wg_last\);",
                      "const bool dead = wg_rows <= 0 || (p.causal && (kv0 > wg_last || it == n_kt - 1));")],
    "dkv_skip_first": [(r"const bool dead = p\.causal && first \+ tp\.P - 1 < kv_w;",
                        "const bool dead = it == 0 || (p.causal && first + tp.P - 1 < kv_w);")],
}
CHECKED = {"sound", "dq_skip_diag", "dkv_skip_first"}  # run through the checks instead of the timer


def time_here(name: str) -> None:
    """In a variant's copy: build its kernels and time both at the training shape."""
    c = kv.chip_smoke()
    import torch

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
    training checks on them."""
    c = kv.chip_smoke()
    import torch

    c.phase_build(strict=False)
    cfg = c.get_config(c.ARCH)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=c.DEV).manual_seed(3)
    for B, S, Hh, KVHh, Dh, kw in ((c.TRAIN_BATCH, c.TRAIN_SEQ, H, KVH, D, {"by_rows": True}),
                                   (2, 100, 6, 2, 64, {}), (2, 100, 8, 2, 64, {"q_offset": 64})):
        kv.report(name, f"flash_bwd_case B{B} S{S} H{Hh} KVH{KVHh} D{Dh} causal {kw}",
                  lambda: c.flash_bwd_case(gen, B, S, S, Hh, KVHh, Dh, True, **kw))
        torch.cuda.empty_cache()
    kv.report(name, "one_step granite-3-2b", lambda: c.one_step(cfg, c.build_model(cfg), c.make_plan(cfg, None)))
    torch.cuda.empty_cache()
    # head_dim 160: stablelm-12b's backward shape, and its one-step check at full width and depth 2
    kv.report(name, "flash_bwd_case B2 S4096 H32 KVH8 D160 causal",
              lambda: c.flash_bwd_case(gen, c.TRAIN_BATCH, c.TRAIN_SEQ, c.TRAIN_SEQ, 32, 8, 160, True, by_rows=True))
    torch.cuda.empty_cache()
    slm = c.stablelm_train_config()
    kv.report(name, "one_step stablelm-12b depth 2",
              lambda: c.one_step(slm, c.build_model(slm), c.make_plan(slm, None), c.STABLELM_TOL))
    torch.cuda.empty_cache()
    # G = 1: whisper-base's cross attention, and the one-step checks of olmoe-1b-7b and whisper-base
    kv.report(name, "flash_bwd_case B8 Sq448 Skv1500 H8 KVH8 D64 non-causal",
              lambda: c.flash_bwd_case(gen, c.BATCH, c.WHISPER_PROMPT + c.NEW, c.WHISPER_FRAMES, 8, 8, 64, False,
                                       by_rows=True))
    torch.cuda.empty_cache()
    olmoe = c.olmoe_train_config()
    kv.report(name, "one_step olmoe-1b-7b depth 2",
              lambda: c.one_step(olmoe, c.build_model(olmoe), c.make_plan(olmoe, None), c.OLMOE_TOL))
    torch.cuda.empty_cache()
    wcfg = c.get_config(c.WHISPER_ARCH)
    kv.report(name, "one_step whisper-base",
              lambda: c.one_step(wcfg, c.build_model(wcfg), c.make_plan(wcfg, None), c.WHISPER_TOL,
                                 batch_size=c.BATCH, seq=c.WHISPER_PROMPT + c.NEW))


if __name__ == "__main__":
    kv.main(__doc__, kernel=KERNEL, edits=EDITS, checked=CHECKED, default=["full", "noexp", "nosecond"],
            time_here=time_here, check_here=check_here)
