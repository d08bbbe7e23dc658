"""The 3xTF32 arithmetic of the port's CUDA prefill kernel
(``ops/csrc/flash_prefill.cu``), emulated in plain PyTorch on the CPU.

The kernel takes both dots of causal attention (``q k^T`` and ``P v``) on
the tensor cores in 3xTF32: each f32 operand x is split into big = rna(x)
and small = rna(x - big), where rna rounds to a tf32 value (10-bit
mantissa, to nearest, ties away from zero: ``cvt.rna.tf32.f32``, done on
the int32 view here as in the kernel), and each 8-value slice of a
contraction takes three tensor-core products (big.small, small.big,
big.big for q k^T; small.big, big.small, big.big for P v). The tensor
cores sum exact products and round the result toward zero; this file
models each product as one such rounding of the exact sum (``_mma``). The
kernel chains the products of four slices on a fresh accumulator and adds
it to the running sum in f32: each 32-value box of D for q k^T, each
32-key tile for P v (added to the rescaled output). This file runs that
arithmetic, in that order, inside the kernel's 32-key online softmax, and
holds it to the checks the kernel meets on the card:

- soft inputs (normal q, k, v): ``allclose`` against ``flash_prefill_plain``
  at rtol 2e-5, atol 2e-6;
- sharp inputs (q and k times 3, logits up to ~40): the max-abs error
  against a float64 attention at most 1.25x the plain f32 version's own.
  There the rtol/atol gate measures summation order: logits rounded
  exactly from float64 already fail it.

The model is not the hardware (which may also drop bits while it aligns
the products): the card runs the same checks on the kernel
(``tests/test_torch_cuda.py``). The model does show why the kernel starts
every four slices from zero: chaining all products on one accumulator, as
a plain loop of tensor-core products would, drifts toward zero and misses
the sharp bound.
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as ``cvt.rna.tf32.f32``: add half of the 13
    dropped bits to the magnitude (the int32 view), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    big = _rna(x)
    return big, _rna(x - big)


def _mma(acc, a, b):
    """One tensor-core product, modelled: ``acc + a @ b`` with exact
    products, the sum rounded once toward zero to f32."""
    exact = acc.double() + a.double() @ b.double()
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _dot3(a, b, acc, chained=False, small_a_first=False):
    """``acc + a @ b`` as the kernel takes it: the three products of each
    8-value slice (big.small, small.big, big.big, or small.big first with
    ``small_a_first``) chained on a fresh accumulator over four slices,
    which is then added to ``acc`` in f32; ``chained`` puts every product
    straight on ``acc`` instead."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    first = (as_, bb, ab, bs) if small_a_first else (ab, bs, as_, bb)
    t = acc if chained else torch.zeros_like(acc)
    for n, k0 in enumerate(range(0, a.shape[-1], 8), 1):
        sl = slice(k0, k0 + 8)
        t = _mma(t, first[0][..., sl], first[1][..., sl, :])
        t = _mma(t, first[2][..., sl], first[3][..., sl, :])
        t = _mma(t, ab[..., sl], bb[..., sl, :])
        if not chained and (n % 4 == 0 or k0 + 8 >= a.shape[-1]):
            acc, t = acc + t, torch.zeros_like(acc)
    return t if chained else acc


def _prefill_3xtf32(q, k, v, block_k: int = 32, chained=False):
    """``flash_prefill_plain`` over the kernel's 32-key tiles with both
    dots in its 3xTF32: q k^T in fresh 32-value boxes of D, P v of each
    tile in a fresh accumulator added to the rescaled output (``chained``:
    every product of both on one accumulator)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = AT._scale_f32(D)
    qh = q.reshape(B, S, KVH, G, D).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)[:, :, None]
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KVH, G, S, 1), AT._NEG_INF)
    s = torch.zeros((B, KVH, G, S, 1))
    acc = torch.zeros((B, KVH, G, S, D))
    tq = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kb, vb = kh[..., k0:k0 + block_k, :], vh[..., k0:k0 + block_k, :]
        n = kb.shape[-2]
        logits = _dot3(qh, kb.transpose(-1, -2),
                       torch.zeros((B, KVH, G, S, n)), chained) * scale
        valid = k0 + torch.arange(n)[None, :] <= tq
        logits = torch.where(valid, logits, torch.full_like(logits,
                                                            AT._NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        s = s * alpha + p.sum(dim=-1, keepdim=True)
        pv = vb.expand(B, KVH, G, n, D)
        acc = (_dot3(p, pv, acc * alpha, True, True) if chained else
               acc * alpha + _dot3(p, pv, torch.zeros_like(acc),
                                   small_a_first=True))
        m = m_new
    return (acc / s).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def _truth_f64(q, k, v):
    """Causal softmax attention in float64, with the f32 scale the kernels
    multiply by."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qd = q.double()
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", qd, kd) * AT._scale_f32(D)
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(logits, dim=-1), vd)


def _inputs(seed, B, S, KVH, G, D, sharp=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, S, KVH * G, D), (B, S, KVH, D),
                             (B, S, KVH, D)))
    return q * sharp, k * sharp, v


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                 # tf32 ulp at 1
    x = torch.tensor([one + ulp / 2,             # tie: away from zero
                      -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23,  # below the tie: down
                      one + 1.5 * ulp,           # tie: away (to 1 + 2 ulp)
                      one + ulp,                 # tf32 already: unchanged
                      2.0 ** -136,               # tf32 subnormal: unchanged
                      3.0 * 2.0 ** -140],        # below half its ulp: 0
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         one + ulp, 2.0 ** -136, 0.0], dtype=torch.float32)
    assert torch.equal(_rna(x), want)
    assert not (_rna(x).view(torch.int32) & 0x1FFF).any()


def test_split_is_exact_to_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 1e3
    big, small = _split(x)
    assert torch.equal(_rna(big), big) and torch.equal(_rna(small), small)
    # x - big is exact in f32; big + small keeps x to 2^-22 of its size
    assert torch.equal((x.double() - big.double()).float(), x - big)
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("B,S,KVH,G,D", [
    (1, 64, 2, 1, 32), (1, 128, 2, 2, 128), (1, 200, 1, 4, 32),
    (2, 256, 4, 1, 128), (1, 256, 2, 1, 32)])
def test_3xtf32_meets_the_plain_gate(B, S, KVH, G, D):
    q, k, v = _inputs(1000 + S + G + D, B, S, KVH, G, D)
    ref = AT.flash_prefill_plain(q, k, v)
    got = _prefill_3xtf32(q, k, v)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("B,S,KVH,G,D", [(1, 256, 4, 1, 128),
                                         (1, 256, 2, 2, 128)])
def test_3xtf32_sharp_logits_within_plain_error_of_f64(B, S, KVH, G, D):
    q, k, v = _inputs(1100 + S + G, B, S, KVH, G, D, sharp=3.0)
    truth = _truth_f64(q, k, v)
    plain_err = float((AT.flash_prefill_plain(q, k, v).double()
                       - truth).abs().max())
    err = float((_prefill_3xtf32(q, k, v).double() - truth).abs().max())
    print(f"sharp S={S} KVH={KVH} G={G}: 3xTF32 {err:.3e}, plain f32 "
          f"{plain_err:.3e} against float64")
    assert err <= 1.25 * plain_err, (err, plain_err)


def test_chained_accumulation_misses_the_sharp_bound():
    # the same arithmetic with every product chained on one accumulator: its
    # rounding toward zero drifts, at about twice the plain version's error
    q, k, v = _inputs(1100 + 256 + 1, 1, 256, 4, 1, 128, sharp=3.0)
    truth = _truth_f64(q, k, v)
    plain_err = float((AT.flash_prefill_plain(q, k, v).double()
                       - truth).abs().max())
    err = float((_prefill_3xtf32(q, k, v, chained=True).double()
                 - truth).abs().max())
    assert err > 1.25 * plain_err, (err, plain_err)
