"""The port's executable takum ISA and its wide / log codecs against
``repro``'s, on the CPU.

* ``core.takum`` at t32: encode bit for bit on an f32 sweep (specials,
  subnormals under DAZ, the f32 rails); decode bit for bit on every t8 / t16
  code and 2^16 seeded t32 codes, ``repro``'s double rounding of a 27-bit
  fraction included (ROADMAP R9: the port follows it; the float64 oracle
  rounded once differs there).  The SR encoder at n = 32 against ``repro``'s
  fed the same draws, but where a body is shorter than the kept bits (R10).
* Log mode (``repro``'s f32 ``log2`` / ``exp2`` steps; torch's differ by an
  ulp): decode within 4 f32 ulps; encode codes equal at t8 / t16 but where
  an ulp of ``log2`` moves a rounding boundary, and there within one code,
  one of the two ``takum_np.encode``'s; at t32, where a code is finer than
  an f32 ulp of the log-value l, the two codes' log-values within four f32
  ulps of l, the 23-bit fraction's quantum and one code.
* Every ``REGISTRY`` family in linear mode bit for bit over the sets
  ``chip_smoke.py`` (o) runs on the card, cut to 2^16 elements: every t8
  pair, every t16 code with 2^16 seeded t16 / t32 pairs and every pair of
  {0, NaR, +-minpos, +-maxpos, +-1}; ``vcvtt2t`` for every (m, n) of
  {8, 16, 32}; ``tests/test_isa.py``'s cases; its narrow-then-widen
  projection over every t16 code.  ``vfmaddt``: XLA's CPU backend does not
  contract ``x * y + z`` into one FMA (two f32 roundings) and flushes a
  subnormal product; the port does both.
* ``vdppt``: codes equal ``repro``'s where the two f32 sums agree (their
  order differs), the sums within the f32 reordering bound elsewhere, and
  there within one code at 8 -> 16 on these inputs (a sum that cancels far
  below sum |x y| can part by more codes: ``chip_smoke.py`` (o3) reads how
  many; at 16 -> 32 a code is finer than the sums' ulp); each code is the
  port's encode of its own sum.  The tiled VDPPT, K4 through ``ops.dual_matmul``
  with ``out_fmt`` (its plain version here), against ``vdppt``'s matrix
  form the same way, and bit for bit the encode of K4's unfused output.

Inputs are built once per module and ``repro``'s jitted codecs compile once
per (width, shape, mode).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import isa as jisa
from repro.core import takum as jtakum
from repro.core import takum_np as jtakum_np
from repro.quant import policy as jpolicy
from repro_torch.core import isa, takum
from repro_torch.kernels import ops
from repro_torch.quant import policy

WIDTHS = (8, 16, 32)
NP_STORAGE = {8: np.uint8, 16: np.uint16, 32: np.uint32}
N_SEEDED = 1 << 16


def _t(a) -> torch.Tensor:
    """numpy codes or floats -> a CPU tensor (unsigned 16/32 through their
    signed views)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.uint16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _n(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _assert_same(got: torch.Tensor, want) -> None:
    """Same dtype and bits (any NaN matches any NaN)."""
    want = np.asarray(want)
    got = _n(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if want.dtype == np.float32:
        nan_g, nan_w = np.isnan(got), np.isnan(want)
        assert np.array_equal(nan_g, nan_w)
        bad = got[~nan_g].view(np.uint32) != want[~nan_w].view(np.uint32)
        assert not bad.any(), f"{bad.sum()} of {bad.size} differ"
    else:
        assert np.array_equal(got, want), f"{(got != want).sum()} of {got.size} differ"


def _specials(n: int) -> np.ndarray:
    """0, NaR, +-minpos, +-maxpos, +-1 as n-bit codes."""
    full = 1 << n
    half = 1 << (n - 1)
    one = 1 << (n - 2)
    return np.array([0, half, 1, full - 1, half - 1, half + 1, one, full - one],
                    np.uint64).astype(NP_STORAGE[n])


@functools.lru_cache(maxsize=None)
def _operands(n: int):
    """(a, b, c): codes of one shape per width.  t8: every (a, b) pair; t16 /
    t32: 2^16 seeded pairs; then every pair of the specials (64)."""
    sp = _specials(n)
    pa, pb = np.repeat(sp, sp.size), np.tile(sp, sp.size)
    if n == 8:
        allc = np.arange(1 << 16, dtype=np.uint32)
        a, b = (allc >> 8).astype(np.uint8), (allc & 0xFF).astype(np.uint8)
    else:
        rng = np.random.default_rng(n)
        a, b = (rng.integers(0, 1 << n, N_SEEDED, dtype=np.uint64).astype(NP_STORAGE[n])
                for _ in range(2))
    a, b = np.concatenate([a, pa]), np.concatenate([b, pb])
    return a, b, np.roll(b, 1)


@functools.lru_cache(maxsize=None)
def _unary(n: int) -> np.ndarray:
    """Every t8 / t16 code (t32: 2^16 seeded), then the specials."""
    if n == 32:
        body = np.random.default_rng(33).integers(0, 1 << 32, N_SEEDED, dtype=np.uint64)
    else:
        body = np.arange(1 << n, dtype=np.uint64)
    return np.concatenate([body.astype(NP_STORAGE[n]), _specials(n)])


def _f32_sweep(seed=0) -> np.ndarray:
    """f32 encode inputs: every binade at random, specials, DAZ subnormals,
    the f32 rails, random bit patterns."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 2.0, 1 << 15) * 2.0 ** rng.integers(-130, 128, 1 << 15).astype(np.float64)
    x *= rng.choice([-1.0, 1.0], x.size)
    with np.errstate(over="ignore"):
        x = x.astype(np.float32)
    f32 = np.finfo(np.float32)
    sp = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, f32.max, -f32.max, f32.tiny,
                   -f32.tiny, f32.smallest_subnormal, -f32.smallest_subnormal, 1e-40, -1e-40,
                   1.0, -1.0, 1.0 + 2.0 ** -23, 2.0 ** 64, 2.0 ** -64], np.float32)
    bits = rng.integers(0, 1 << 32, 1 << 14, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([x, sp, bits.view(np.float32)])


def _kind(n: int) -> dict:
    return {8: "t8", 16: "t16", 32: "t32"}[n]


# ---------------------------------------------------------------------------
# the codec: t32 and the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_encode_bit_exact_on_f32_sweep(n):
    x = _f32_sweep()
    want = np.asarray(jtakum.takum_encode(x, n))
    got = takum.pack(takum.takum_encode(_t(x), n), n)
    _assert_same(got, want)


@pytest.mark.parametrize("n", WIDTHS)
def test_decode_bit_exact(n):
    codes = _unary(n)
    _assert_same(takum.takum_decode(_t(codes), n), np.asarray(jtakum.takum_decode(codes, n)))


def _double_rounding_code() -> int:
    """A t32 code (c = 0, p = 27) whose fraction rounds differently once
    (to 23 bits) and twice (24 significant bits, then 23): M = (X << 4) | 7
    with X odd rounds down once, but up to a tie and then to X + 1 twice."""
    X = (1 << 22) + 1
    return (1 << 30) | (X << 4) | 7


def test_t32_decode_rounds_twice_as_repro():
    """ROADMAP R9: ``repro``'s t32 decode rounds the 27-bit fraction twice.
    The port equals it on every seeded code, and on the codes where the
    float64 oracle rounded once to f32 differs (more than 2 % of the normal
    range) the port is ``repro``'s, not the oracle's."""
    codes = np.concatenate([_unary(32), np.array([_double_rounding_code()], np.uint32)])
    want = np.asarray(jtakum.takum_decode(codes, 32))
    got = _n(takum.takum_decode(_t(codes), 32))
    with np.errstate(over="ignore"):
        once = jtakum_np.decode(codes.astype(np.uint64), 32, "linear").astype(np.float32)
    normal = np.isfinite(once) & (np.abs(once) >= 2.0 ** -126) & (np.abs(once) <= np.finfo(np.float32).max)
    twice = normal & (once.view(np.uint32) != want.view(np.uint32))
    assert twice[-1], "the constructed code must round differently twice"
    assert twice.sum() > 0.02 * normal.sum()
    assert np.array_equal(got[twice].view(np.uint32), want[twice].view(np.uint32))
    _assert_same(torch.from_numpy(got), want)


def test_decode_f32bits_keeps_its_n_le_28_contract():
    with pytest.raises(ValueError):
        takum.takum_decode_f32bits(torch.zeros(3, dtype=torch.int64), 32)
    with pytest.raises(ValueError):
        jtakum.takum_decode_f32bits(jnp.zeros(3, jnp.uint32), 32)


@pytest.mark.parametrize("n", WIDTHS)
def test_storage_dtype_and_sortable_int(n):
    codes = _unary(n)
    assert takum.storage_dtype(n) == {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}[n]
    assert np.dtype(jtakum.storage_dtype(n)) == np.dtype(NP_STORAGE[n])
    got = takum.sortable_int(_t(codes), n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jtakum.sortable_int(codes, n)))
    assert takum.pack(got.to(torch.int64), n).dtype == takum.storage_dtype(n)
    _assert_same(takum.pack(got.to(torch.int64), n), codes)


@pytest.mark.parametrize("n", (16, 32))
def test_sr_encode_against_repro_draws(n):
    """``repro``'s SR encode fed the same uint32 draws: equal wherever the
    body has at least the n - 1 kept bits; where it is shorter (t32, |c| <
    15) ``repro`` keeps the body unshifted (R10) and the port gives the
    exact code, the RNE encode's."""
    x = _f32_sweep(1)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jtakum.takum_encode_sr(x, key, n))
    rnd = np.array(jax.random.bits(key, x.shape, jnp.uint32)).view(np.int32)
    got = _n(takum.pack(takum.takum_encode_sr(_t(x), n, torch.from_numpy(rnd)), n))
    ax = np.abs(x.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.floor(np.log2(np.where((ax >= 2.0 ** -126) & np.isfinite(ax), ax, 1.0)))
    short = (n == 32) & (c >= -16) & (c <= 15)
    assert np.array_equal(got[~short], want[~short])
    if n == 32:
        assert short.sum() > 1000 and (got[short] != want[short]).any()
        exact = np.asarray(jtakum.takum_encode(x, n))
        assert np.array_equal(got[short], exact[short])


# ---------------------------------------------------------------------------
# log mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_log_decode_within_4_ulps(n):
    codes = _unary(n)
    want = np.asarray(jtakum.takum_decode(codes, n, mode="log"))
    got = _n(takum.takum_decode(_t(codes), n, "log"))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulps = np.abs(got[ok].view(np.int32).astype(np.int64) - want[ok].view(np.int32))
    assert ulps.max() <= 4, ulps.max()
    assert np.array_equal(got[ok] == 0, want[ok] == 0)  # the same codes flush


def _log_value(codes: np.ndarray, n: int) -> np.ndarray:
    """The exact log-value c + M / 2**p of n-bit codes (float64)."""
    neg, c, M, p = takum._decode_fields(torch.from_numpy(codes.astype(np.int64)), n)
    ell = c.double() + M.double() / torch.pow(2.0, p.double())
    return torch.where(neg, -ell, ell).numpy()


@pytest.mark.parametrize("n", WIDTHS)
def test_log_encode_within_an_ulp_of_log2(n):
    """Equal codes but where torch's and XLA's f32 ``log2`` (an ulp or two
    apart) fall on either side of a rounding boundary.  At t8 / t16 a code
    is coarser than that ulp: such codes are neighbours (t16: 6 of the
    sweep's 49171; t8: none), and one of each pair is the float64
    oracle's.  At t32 a code is finer than an f32 ulp of the log-value l (up
    to 16 codes at |l| > 128; 24 % of the sweep differ): the two codes'
    log-values lie within four f32 ulps of l (two ulps of ``log2`` times
    1/log2(sqrt e) < 1.39, and the rounding of that product and of its
    fraction), plus the fraction's 2^-23 quantum and one code."""
    x = _f32_sweep()
    want = np.asarray(jtakum.takum_encode(x, n, mode="log")).astype(np.int64)
    got = takum.takum_encode(_t(x), n, "log").numpy()
    diff = got != want
    assert diff.mean() < (0.001 if n < 32 else 0.3)
    if n < 32:
        step = np.abs(((got - want + (1 << (n - 1))) % (1 << n)) - (1 << (n - 1)))
        assert step.max() <= 1
        oracle = jtakum_np.encode(x.astype(np.float64), n, "log").astype(np.int64)
        assert np.all((got[diff] == oracle[diff]) | (want[diff] == oracle[diff]))
    else:
        lg, lw = _log_value(got[diff], n), _log_value(want[diff], n)
        ulp = np.spacing(np.abs(lw).astype(np.float32)).astype(np.float64)
        _, _, _, p = takum._decode_fields(torch.from_numpy(want[diff]), n)
        code = 2.0 ** -p.double().numpy()
        assert np.all(np.abs(lg - lw) <= 4 * ulp + 2.0 ** -23 + code)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        takum.takum_encode(torch.zeros(2), 16, "posit")
    with pytest.raises(ValueError):
        takum.takum_decode(torch.zeros(2, dtype=torch.int64), 16, "posit")


# ---------------------------------------------------------------------------
# the ISA families, linear mode, bit for bit
# ---------------------------------------------------------------------------

BINARY = ("VADDT", "VSUBT", "VMULT", "VDIVT", "VMINT", "VMAXT")
UNARY = ("VSQRTT", "VNEGT", "VABST", "VCVTPT2PS")


def test_registry_keys_match():
    assert list(isa.REGISTRY) == list(jisa.REGISTRY)
    assert len(isa.REGISTRY) == 15


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", BINARY)
def test_binary_family_bit_exact(name, n):
    a, b, _ = _operands(n)
    _assert_same(isa.REGISTRY[name](_t(a), _t(b), n), np.asarray(jisa.REGISTRY[name](a, b, n)))


@pytest.mark.parametrize("n", WIDTHS)
def test_vcmpt_every_predicate_bit_exact(n):
    a, b, _ = _operands(n)
    for op in ("lt", "le", "eq", "gt", "ge", "ne"):
        got = isa.vcmpt(_t(a), _t(b), n, op)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(jisa.vcmpt(a, b, n, op))), op
    with pytest.raises(KeyError):
        isa.vcmpt(_t(a), _t(b), n, "lg")


@pytest.mark.parametrize("n", WIDTHS)
def test_vfmaddt_bit_exact(n):
    a, b, c = _operands(n)
    _assert_same(isa.vfmaddt(_t(a), _t(b), _t(c), n), np.asarray(jisa.vfmaddt(a, b, c, n)))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", UNARY)
def test_unary_family_bit_exact(name, n):
    a = _unary(n)
    _assert_same(isa.REGISTRY[name](_t(a), n), np.asarray(jisa.REGISTRY[name](a, n)))


@pytest.mark.parametrize("n", WIDTHS)
def test_vcvtps2pt_bit_exact(n):
    x = np.concatenate([_f32_sweep(2), np.asarray(jisa.vcvtpt2ps(_unary(n), n))])
    _assert_same(isa.vcvtps2pt(_t(x), n), np.asarray(jisa.vcvtps2pt(x, n)))


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("n", WIDTHS)
def test_vcvtt2t_bit_exact(m, n):
    a = _unary(m)
    _assert_same(isa.vcvtt2t(_t(a), m, n), np.asarray(jisa.vcvtt2t(a, m, n)))


def test_narrow_then_widen_projection_every_t16_code():
    """``tests/test_isa.py``'s hypothesis property over every t16 code:
    narrowing 16 -> 8 then widening and narrowing again is a projection."""
    a = torch.arange(1 << 16, dtype=torch.int64)
    n8 = isa.vcvtt2t(a, 16, 8)
    back = isa.vcvtt2t(n8, 8, 16)
    again = isa.vcvtt2t(back, 16, 8)
    assert torch.equal(n8, again)
    assert back.dtype == torch.uint16 and n8.dtype == torch.uint8
    _assert_same(n8, np.asarray(jisa.vcvtt2t(np.arange(1 << 16, dtype=np.uint32), 16, 8)))


def test_integer_families_run_on_int64_codes():
    """Codes in another integer dtype are read by value, as ``repro``'s
    ``astype(uint32)`` reads them."""
    a, b, _ = _operands(16)
    for name in ("VADDT", "VMINT"):
        _assert_same(isa.REGISTRY[name](_t(a.astype(np.int64)), _t(b.astype(np.int64)), 16),
                     np.asarray(jisa.REGISTRY[name](a, b, 16)))
    _assert_same(isa.vnegt(_t(a.astype(np.int64)), 16), np.asarray(jisa.vnegt(a, 16)))
    _assert_same(isa.vabst(_t(a.astype(np.int64)), 16), np.asarray(jisa.vabst(a, 16)))
    _assert_same(isa.vcvtt2t(_t(a.astype(np.int64)), 16, 32), np.asarray(jisa.vcvtt2t(a, 16, 32)))


@pytest.mark.parametrize("n", (5, 12, 24))
def test_integer_families_on_widths_short_of_their_container(n):
    """Widths that do not fill their storage dtype: keys sign-extended in
    the signed container, results masked to n bits, as ``repro``'s."""
    rng = np.random.default_rng(40 + n)
    body = np.concatenate([np.arange(min(1 << n, 1 << 12), dtype=np.uint64),
                           rng.integers(0, 1 << n, 1 << 12, dtype=np.uint64)])
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[takum.storage_dtype(n).itemsize]
    a, b = body.astype(dt), np.roll(body, 7).astype(dt)
    for op in ("lt", "le", "eq", "gt", "ge", "ne"):
        assert np.array_equal(isa.vcmpt(_t(a), _t(b), n, op).numpy(),
                              np.asarray(jisa.vcmpt(a, b, n, op))), op
    for name in ("VMINT", "VMAXT"):
        _assert_same(isa.REGISTRY[name](_t(a), _t(b), n), np.asarray(jisa.REGISTRY[name](a, b, n)))
    for name in ("VNEGT", "VABST"):
        _assert_same(isa.REGISTRY[name](_t(a), n), np.asarray(jisa.REGISTRY[name](a, n)))
    for m in (n // 2, 2 * n):
        if 2 <= m <= 32:
            _assert_same(isa.vcvtt2t(_t(a), n, m), np.asarray(jisa.vcvtt2t(a, n, m)))


def test_vfmaddt_flushes_a_subnormal_product():
    """x * y = 2^-128 (subnormal in f32) beside z = 1.5 * 2^-126: XLA's CPU
    backend flushes the product, so the result is z's code; keeping the
    subnormal would give 1.75 * 2^-126."""
    vals = np.array([2.0 ** -64, 2.0 ** -64, 1.5 * 2.0 ** -126], np.float32)
    x, y, z = (np.asarray(jtakum.takum_encode(vals[i:i + 1], 16)) for i in range(3))
    want = np.asarray(jisa.vfmaddt(x, y, z, 16))
    got = isa.vfmaddt(_t(x), _t(y), _t(z), 16)
    _assert_same(got, want)
    assert _n(got)[0] == z[0]
    kept = np.asarray(jtakum.takum_encode(np.array([1.75 * 2.0 ** -126], np.float32), 16))
    assert kept[0] != z[0]


def _jenc(x, n):
    return jtakum.takum_encode(jnp.asarray(x, dtype=jnp.float32), n)


def test_repro_isa_cases_hold_on_the_port():
    """``tests/test_isa.py``'s ISA cases on the same inputs: each of the
    port's outputs equals ``repro``'s bit for bit."""
    for n in (8, 16):
        rng = np.random.default_rng(3)
        ea = np.asarray(_jenc(rng.standard_normal(512).astype(np.float32) * 4, n))
        eb = np.asarray(_jenc(rng.standard_normal(512).astype(np.float32) * 4, n))
        for name in ("VADDT", "VSUBT", "VMULT", "VDIVT"):
            _assert_same(isa.REGISTRY[name](_t(ea), _t(eb), n),
                         np.asarray(jisa.REGISTRY[name](ea, eb, n)))
        rng = np.random.default_rng(9)
        ca = np.asarray(_jenc(rng.standard_normal(2048) * np.exp(rng.uniform(-10, 10, 2048)), n))
        cb = np.asarray(_jenc(rng.standard_normal(2048) * np.exp(rng.uniform(-10, 10, 2048)), n))
        for op in ("lt", "ge"):
            assert np.array_equal(isa.vcmpt(_t(ca), _t(cb), n, op).numpy(),
                                  np.asarray(jisa.vcmpt(ca, cb, n, op)))
        _assert_same(isa.vmint(_t(ca), _t(cb), n), np.asarray(jisa.vmint(ca, cb, n)))
        _assert_same(isa.vmaxt(_t(ca), _t(cb), n), np.asarray(jisa.vmaxt(ca, cb, n)))
    a = np.asarray(_jenc([1.0 + 2.0 ** -3], 8))
    c = np.asarray(_jenc([2.0 ** -6], 8))
    _assert_same(isa.vfmaddt(_t(a), _t(a), _t(c), 8), np.asarray(jisa.vfmaddt(a, a, c, 8)))
    e = np.asarray(_jenc(np.array([1.5, -2.25, 0.0, 7.0, -0.125], np.float32), 16))
    _assert_same(isa.vnegt(_t(e), 16), np.asarray(jisa.vnegt(e, 16)))
    _assert_same(isa.vabst(_t(e), 16), np.asarray(jisa.vabst(e, 16)))
    pats8 = np.arange(256, dtype=np.uint32)
    _assert_same(isa.vcvtt2t(_t(pats8), 8, 16), np.asarray(jisa.vcvtt2t(pats8, 8, 16)))
    e16 = np.asarray(_jenc([1.0 + 2.0 ** -9, 1.0 + 3 * 2.0 ** -9, 1e-30], 16))
    _assert_same(isa.vcvtt2t(_t(e16), 16, 8), np.asarray(jisa.vcvtt2t(e16, 16, 8)))
    rng = np.random.default_rng(11)
    da = np.asarray(_jenc(rng.standard_normal((4, 64)).astype(np.float32), 8))
    db = np.asarray(_jenc(rng.standard_normal((4, 64)).astype(np.float32), 8))
    got = isa.vdppt(_t(da), _t(db), 8)
    assert got.dtype == torch.uint16
    _assert_same(got, np.asarray(jisa.vdppt(da, db, 8)))
    x = np.array([0.0, 1.0, -3.5, 1e-20, 1e20], np.float32)
    e = isa.vcvtps2pt(_t(x), 16)
    _assert_same(e, np.asarray(jisa.vcvtps2pt(jnp.asarray(x), 16)))
    _assert_same(isa.vcvtpt2ps(e, 16), np.asarray(jisa.vcvtpt2ps(_n(e), 16)))


def test_numpy_inputs_go_to_the_named_device():
    a = np.array([1, 2, 0x8000], np.uint16)
    out = isa.vnegt(a, 16, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.uint16
    _assert_same(out, np.asarray(jisa.vnegt(a, 16)))


# ---------------------------------------------------------------------------
# vdppt and the tiled VDPPT (K4)
# ---------------------------------------------------------------------------


def _dot_operands(n_in: int, M=48, K=256):
    rng = np.random.default_rng(100 + n_in)
    x = (rng.standard_normal((2, M, K)) * np.exp(rng.uniform(-3, 3, (2, M, K)))).astype(np.float32)
    a, b = (np.asarray(jtakum.takum_encode(v, n_in)) for v in x)
    return a, b


def _reorder_bound(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K eps sum |x y|: how far two f32 summation orders of the products
    may part (the ROADMAP's accumulation-order tolerance)."""
    K = x.shape[-1]
    return K * 2.0 ** -24 * torch.sum(torch.abs(x.double() * y.double()), dim=-1)


def _hold_dot(got_codes, got_sum, want_codes, want_sum, n_out, bound):
    """Codes equal where the sums agree; elsewhere the sums within
    ``bound``, each code between the encodes of the other sum -+ ``bound``,
    and within one code at t16 out; every code the port's encode of its own
    sum."""
    _assert_same(got_codes, _n(takum.pack(takum.takum_encode(got_sum, n_out), n_out)))
    g = takum.sortable_int(got_codes, n_out).numpy().astype(np.int64)
    w = takum.sortable_int(_t(want_codes), n_out).numpy().astype(np.int64)
    same = got_sum.numpy().view(np.uint32) == want_sum.numpy().view(np.uint32)
    assert np.array_equal(g[same], w[same])
    gs, ws = got_sum.double().numpy(), want_sum.double().numpy()
    assert np.all(np.abs(gs - ws) <= bound.numpy())
    lo, hi = ((want_sum.double() + s * bound).float() for s in (-1, 1))
    key = lambda v: takum.sortable_int(takum.takum_encode(v, n_out), n_out).numpy()
    assert np.all((key(lo) <= g) & (g <= key(hi)))
    if n_out == 16:
        assert np.abs(g - w).max() <= 1
    return int((~same).sum()), int(np.abs(g - w).max())


@pytest.mark.parametrize("n_in", (8, 16))
def test_vdppt_against_repro(n_in):
    a, b = _dot_operands(n_in)
    want = np.asarray(jisa.vdppt(a, b, n_in))
    x = np.array(jtakum.takum_decode(a, n_in))
    y = np.array(jtakum.takum_decode(b, n_in))
    want_sum = torch.from_numpy(np.array(jnp.sum(jnp.asarray(x) * jnp.asarray(y), axis=-1)))
    got = isa.vdppt(_t(a), _t(b), n_in)
    assert got.dtype == takum.storage_dtype(2 * n_in)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got_sum = torch.sum(tx * ty, dim=-1)
    _hold_dot(got, got_sum, want, want_sum, 2 * n_in, _reorder_bound(tx, ty))


@pytest.mark.parametrize("n_in", (8, 16))
def test_tiled_vdppt_on_k4_against_vdppt_matrix_form(n_in):
    """K4 (``ops.dual_matmul`` with ``out_fmt`` t16 / t32; its plain version
    on the CPU) against ``vdppt(a[:, None, :], b[None, :, :], n_in)``, and
    bit for bit the encode of K4's own unfused output."""
    a, b = _dot_operands(n_in, M=24, K=96)
    ta, tb = _t(a), _t(b)
    fmt, out_fmt = _kind(n_in), _kind(2 * n_in)
    wT = _t(np.ascontiguousarray(b.T))
    tiled = ops.dual_matmul(ta, wT, fmt, out_fmt=out_fmt)
    unfused = ops.dual_matmul(ta, wT, fmt)
    _assert_same(tiled, _n(ops.encode(unfused, out_fmt)))
    mat = isa.vdppt(ta[:, None, :], tb[None, :, :], n_in)
    assert mat.shape == tiled.shape == (24, 24)
    x, y = takum.takum_decode(ta, n_in), takum.takum_decode(tb, n_in)
    mat_sum = torch.sum(x[:, None, :] * y[None, :, :], dim=-1)
    _hold_dot(tiled, unfused, _n(mat), mat_sum, 2 * n_in,
              _reorder_bound(x[:, None, :], y[None, :, :]))


# ---------------------------------------------------------------------------
# the policy registry
# ---------------------------------------------------------------------------


def test_t32_policies_as_repro():
    assert policy.FORMAT_BITS["t32"] == jpolicy.FORMAT_BITS["t32"] == 32.0
    for surface in ("weights", "kv_cache", "grad_comm", "opt_state", "checkpoint"):
        got = policy.QuantPolicy(**{surface: "t32"})
        want = jpolicy.QuantPolicy(**{surface: "t32"})
        assert getattr(got, surface) == getattr(want, surface) == "t32"
    assert policy.is_takum("t32") and policy.is_takum("takum32")


# ---------------------------------------------------------------------------
# t32 operands: the plain version on any device, as repro takes its reference
# ---------------------------------------------------------------------------


def test_t32_operands_take_the_plain_version_as_repro():
    """A t32 weight, t32 K4 operands and a t32 KV cache: no kernel moves
    t32, so each op runs its plain version (no launch counted), within the
    accumulation-order tolerance of ``repro``'s reference (R1)."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = np.asarray(jtakum.takum_encode(rng.standard_normal((48, 24)).astype(np.float32), 32))
    xb = np.asarray(jtakum.takum_encode(x, 32))
    ops.reset_launch_counts()
    got = ops.matmul(_t(x), _t(w), "t32").numpy()
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w), "t32"))
    scale = np.abs(x) @ np.abs(np.asarray(jtakum.takum_decode(w, 32)))
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    got = ops.dual_matmul(_t(xb), _t(w), 32, out_fmt="t32")
    assert got.dtype == torch.uint32
    _assert_same(got, _n(ops.encode(ops.dual_matmul(_t(xb), _t(w), 32), "t32")))
    want = np.asarray(jops.dual_matmul(jnp.asarray(xb), jnp.asarray(w), 32, out_fmt="t32"))
    got_v, want_v = _n(ops.decode(got, "t32")), np.asarray(jtakum.takum_decode(want, 32))
    assert np.all(np.abs(got_v - want_v) <= 1e-6 * scale)
    q = rng.standard_normal((1, 4, 16)).astype(np.float32)
    kv = np.asarray(jtakum.takum_encode(rng.standard_normal((1, 2, 8, 16)).astype(np.float32), 32))
    got = ops.decode_attention(_t(q), _t(kv), _t(kv), "t32").numpy()
    want = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                            "t32"))
    assert np.abs(got - want).max() <= 1e-5
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
