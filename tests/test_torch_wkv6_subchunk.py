"""A CPU model of the WKV6 kernel's algorithm and number formats
(``src/repro_torch/kernels/csrc/wkv6_scan.cu``), held to the limit the kernel
is held to on the card.

The kernel splits each chunk of 64 tokens into four sub-chunks of 16. Only
the four diagonal 16x16 blocks of the pairwise scores take an exp per
(t, s, k). Each off-diagonal block (i, j), j < i, is one product

    (r_i * 2^(cx_i - b_j)) . (k_j * 2^(b_j - clw_j))^T

with b_j the inclusive cumulative log-decay at the last row of sub-chunk j,
so both factors are <= 1. That product, scores.v, (r 2^cx).S and
(k 2^(clw_C - clw))^T.v run on the tensor cores with every f32 operand cut
into three bf16 parts (each the rounding of what the earlier parts left) and
the partial products of order <= 2 kept: six where both operands are split,
three where one is exact in bf16 (v given in bf16). Exponents are in log2
units, as the kernel's ex2 takes them.

``subchunk_wkv6`` computes that in PyTorch on the CPU: the same sub-chunk
size, the same reference points, the same splits and products, f32
elsewhere. It is held against the reference's Pallas kernel in interpret
mode and against the plain token-by-token version run in float64, at
atol = rtol = 5e-5, the limit ``chip_smoke.py`` holds the kernel to
(``TOL_WKV``). One case plants the fault the kernel could most easily have,
an off-diagonal block whose r factor is decayed to the wrong reference point
(b_i for b_j), and shows that the limit catches it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

TOL = dict(atol=5e-5, rtol=5e-5)
C, SUB, K = 64, 16, 64
LOG2E = 1.4426950408889634
PARTS = 3


def split(x: torch.Tensor) -> list:
    """x (f32) as PARTS bf16 values (held in f32), each the rounding of what
    the earlier parts left of x."""
    parts, rest = [], x
    for _ in range(PARTS):
        p = rest.to(torch.bfloat16).float()
        parts.append(p)
        rest = rest - p
    return parts


def mm(a: torch.Tensor, b: torch.Tensor, b_exact: bool = False) -> torch.Tensor:
    """a @ b as the kernel's tensor cores compute it: bf16 parts, f32
    products and sums, partial products of order <= 2. ``b_exact``: b is
    already a bf16 value and is not split."""
    pa = split(a)
    pb = [b] if b_exact else split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i, x in enumerate(pa):
        for j, y in enumerate(pb):
            if i + j <= PARTS - 1:
                out = out + x @ y
    return out


def subchunk_wkv6(r, k, v, logw, u, state0, *, fault: str = ""):
    """The kernel's algorithm on the CPU: r, k, v (B,T,H,K) in bf16 or f32,
    logw (B,T,H,K), u (H,K), state0 (B,H,K,V) f32. Returns (out, state) f32.

    Rows past T (a short last chunk) are r = k = v = 0, logw = 0.
    ``fault="refpoint"``: the r factor of every off-diagonal block (i, j) is
    decayed to b_i, the last row of its own sub-chunk, instead of b_j.
    """
    v_exact = v.dtype == torch.bfloat16
    B, T, H, _ = r.shape
    n = -(-T // C)
    pad = n * C - T

    def heads(x):  # (B,T,H,X) -> (B,H,n*C,X) f32, zero rows past T
        x = x.float().permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    rf, kf, vf = heads(r), heads(k), heads(v)
    lw = heads(logw) * LOG2E
    uf = u.float()[None, :, None, :]  # (1,H,1,K)
    S = state0.float().clone()
    tri = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), diagonal=-1)
    outs = []
    for c in range(n):
        rows = slice(c * C, (c + 1) * C)
        rc, kc, vc = rf[:, :, rows], kf[:, :, rows], vf[:, :, rows]
        clw = torch.cumsum(lw[:, :, rows], dim=2)  # inclusive, log2 units
        cx = torch.nn.functional.pad(clw[:, :, :-1], (0, 0, 1, 0))  # exclusive
        scores = torch.zeros(B, H, C, C)
        for i in range(C // SUB):
            ti = slice(i * SUB, (i + 1) * SUB)
            # the diagonal block: one exp per (t, s, k), s < t, exponents <= 0
            e = torch.exp2(torch.clamp(cx[:, :, ti, None, :] - clw[:, :, None, ti, :], max=0.0))
            d = (rc[:, :, ti, None, :] * kc[:, :, None, ti, :] * e).sum(-1)
            scores[:, :, ti, ti] = torch.where(tri, d, torch.zeros(()))
            for j in range(i):
                tj = slice(j * SUB, (j + 1) * SUB)
                bj = clw[:, :, j * SUB + SUB - 1, None, :]
                ba = clw[:, :, i * SUB + SUB - 1, None, :] if fault == "refpoint" else bj
                a = rc[:, :, ti] * torch.exp2(cx[:, :, ti] - ba)
                b = kc[:, :, tj] * torch.exp2(bj - clw[:, :, tj])
                scores[:, :, ti, tj] = mm(a, b.transpose(-1, -2))
        out = mm(scores, vc, v_exact)
        out = out + (rc * uf * kc).sum(-1, keepdim=True) * vc
        out = out + mm(rc * torch.exp2(cx), S)
        last = clw[:, :, -1:, :]  # (B,H,1,K)
        kv = mm((kc * torch.exp2(last - clw)).transpose(-1, -2), vc, v_exact)
        S = torch.exp2(last[:, :, 0, :, None]) * S + kv
        outs.append(out)
    out = torch.cat(outs, dim=2)[:, :, :T].permute(0, 2, 1, 3)
    return out, S


def _inputs(B, T, H, decay, dtype, seed=0):
    """r, k, v (``dtype``), logw, u, state0 (f32) from a numpy seed.
    ``decay``: "test" the reference's kernel test, logw = -exp(N/2 - 2);
    "model" the model's init, -exp(N/10 - 6); a float a constant logw."""
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((B, T, H, K), dtype=np.float32) * 0.5 for _ in range(3))
    z = g.standard_normal((B, T, H, K), dtype=np.float32)
    if decay == "test":
        logw = -np.exp(z * 0.5 - 2.0)
    elif decay == "model":
        logw = -np.exp(z * 0.1 - 6.0)
    else:
        logw = np.full_like(z, decay)
    u = g.standard_normal((H, K), dtype=np.float32) * 0.2
    s0 = g.standard_normal((B, H, K, K), dtype=np.float32) * 0.3
    rt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (r, k, v))
    return rt, kt, vt, torch.from_numpy(logw.astype(np.float32)), torch.from_numpy(u), torch.from_numpy(s0)


def _float64(x):
    return ref.wkv6_reference(*(t.double() for t in x))


def _close(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().numpy(), w.double().numpy(), **TOL)


DECAYS = ["test", "model", -3.0, -20.0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("decay", DECAYS)
def test_subchunk_model_matches_float64(decay, dtype):
    x = _inputs(2, 256, 2, decay, dtype)
    _close(subchunk_wkv6(*x), _float64(x))


@pytest.mark.parametrize("decay", ["test", "model"])
def test_subchunk_model_matches_the_pallas_kernel(decay):
    x = _inputs(1, 128, 2, decay, torch.float32, seed=1)
    want = jops.wkv6(*(jnp.asarray(t.numpy()) for t in x), chunk=C, mode="interpret")
    _close(subchunk_wkv6(*x), [torch.from_numpy(np.array(w)) for w in want])


@pytest.mark.parametrize("T,dtype", [(37, torch.bfloat16), (200, torch.float32), (129, torch.bfloat16)])
def test_subchunk_model_masks_a_short_last_chunk(T, dtype):
    x = _inputs(2, T, 3, "test", dtype, seed=2)
    _close(subchunk_wkv6(*x), _float64(x))


@pytest.mark.parametrize("decay", DECAYS)
def test_wrong_reference_point_fails_the_limit(decay):
    x = _inputs(2, 128, 2, decay, torch.bfloat16, seed=3)
    want = _float64(x)
    with pytest.raises(AssertionError):
        _close(subchunk_wkv6(*x, fault="refpoint"), want)


def test_two_bf16_parts_fail_the_limit_at_the_models_decay():
    """The split is no larger than it must be: with two parts the model's slow
    decay (a state that sums hundreds of tokens) leaves the limit."""
    global PARTS
    x = _inputs(2, 256, 2, "model", torch.bfloat16, seed=4)
    want = _float64(x)
    _close(subchunk_wkv6(*x), want)
    saved, PARTS = PARTS, 2
    try:
        with pytest.raises(AssertionError):
            _close(subchunk_wkv6(*x), want)
    finally:
        PARTS = saved
