"""The number format of the "simt" attention kernels, on the CPU.

``csrc/flash_attention.cu`` (``flash_simt_kernel``) and
``csrc/folded_attention.cu`` (``folded_kernel``) run their f32 products on
the tensor cores as 3xTF32: each operand x is split into two tf32 terms,
hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties away
from zero (``cvt.rna.tf32.f32``; tf32 keeps 10 mantissa bits), and a
product is hi·hi + hi·lo + lo·hi with f32 accumulation (each tf32 product is
exact in f32). The kernels cannot run here, so this file emulates that
arithmetic in numpy and holds it against float64 at the shapes the card's
gates check (``chip_smoke.py``): the f32 beam's folded video call (1e-5)
and flash attention at d = 256 and 512 (1e-4, the kernels phase's f32
tolerance). Measured here: 2.2e-7 folded (45x under its gate), 8.5e-7 and
7.2e-7 flash at d 256 and 512 (over 100x under); the asserts keep a margin
of 10x. A single tf32 pass (hi·hi alone) errs by 1.1e-4 folded and 4.2e-4
/ 4.9e-4 flash, above both gates, which is why no f32 route may run as
single-pass TF32.
"""
import numpy as np
import pytest

FOLDED_GATE = 1e-5  # chip_smoke.py: the f32 beam's folded call
FLASH_GATE = 1e-4   # chip_smoke.py: the kernels phase's f32 tolerance
MARGIN = 10


def tf32(x):
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero, kept in float32: the kernels' ``to_tf32``."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a, b):
    """The kernels' product: the small terms first, then hi·hi, in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def matmul_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def attend(q, k, v, scale, matmul, prescale):
    """softmax(scale q kᵀ) v with the online-softmax kernels' f32 steps:
    folded attention scales q before its product (``prescale``), flash
    attention scales the scores; p enters the second product unrounded, l
    sums it, the output is normalised after the product."""
    kt = np.swapaxes(k, -1, -2)
    if prescale:
        s = matmul(q * np.float32(scale), kt)
    else:
        s = matmul(q, kt) * np.float32(scale)
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    return (matmul(p, v) / p.sum(-1, keepdims=True)).astype(np.float32)


def reference(q, k, v, scale):
    s = (q.astype(np.float64) @ np.swapaxes(k, -1, -2).astype(np.float64)
         * scale)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p @ v.astype(np.float64)) / p.sum(-1, keepdims=True)


def folded_beam_case(seed=0):
    """The f32 beam's video call as chip_smoke.py draws it, cut to 4
    clips: G = 32 queries (q_eff at 0.05), S 128 keys, draw 1024, scale
    1/16; keys and values are the memory itself."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(4, 32, 1024) * 0.05).astype(np.float32)
    mem = rng.randn(4, 128, 1024).astype(np.float32)
    return q, mem, mem, 1.0 / 16, True, FOLDED_GATE


def flash_case(d, seed=1):
    """One head of flash attention at head width d: 128 queries and keys
    of randn q, k, v (the kernels phase's inputs), scale 1/sqrt(d)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, 128, d).astype(np.float32) for _ in range(3))
    return q, k, v, 1.0 / np.sqrt(d), False, FLASH_GATE


CASES = {"folded f32 beam G=32": folded_beam_case,
         "flash d=256": lambda: flash_case(256),
         "flash d=512": lambda: flash_case(512)}


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_sits_under_the_gates(case):
    q, k, v, scale, prescale, gate = CASES[case]()
    err = np.abs(attend(q, k, v, scale, matmul_3xtf32, prescale)
                 - reference(q, k, v, scale)).max()
    assert err * MARGIN < gate, (case, err)


@pytest.mark.parametrize("case", list(CASES))
def test_single_pass_tf32_fails_the_gates(case):
    q, k, v, scale, prescale, gate = CASES[case]()
    err = np.abs(attend(q, k, v, scale, matmul_1xtf32, prescale)
                 - reference(q, k, v, scale)).max()
    assert err > gate, (case, err)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # tf32's spacing at 1.0
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp,
                  -(1 + ulp / 2), 3.0, 0.0], np.float32)
    want = np.array([1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    # the result has no bits below tf32's 10-bit mantissa
    rng = np.random.RandomState(2)
    r = tf32(rng.randn(1000).astype(np.float32) * 100)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()


def test_two_terms_carry_about_22_bits():
    """|x - (hi + lo)| <= 2^-22 |x|: hi leaves at most half a tf32 ulp
    (2^-11 |x|), lo rounds that to 11 significant bits."""
    rng = np.random.RandomState(3)
    x = (rng.randn(100000) * np.exp(rng.randn(100000) * 4)).astype(np.float32)
    hi, lo = split(x)
    rel = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64)) / np.abs(x.astype(np.float64))
    assert rel.max() <= 2.0 ** -22
    assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()
