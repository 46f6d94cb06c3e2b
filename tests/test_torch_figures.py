"""The port's figure registry and its copies of ``repro``'s instruction
tables, on the CPU.

* ``core/avx10.py`` and ``core/streamline.py`` (plain Python data): the same
  groups, expansions, counts and reports as ``repro``'s.
* ``core/posit_np.py`` on the port's ``bitround``: every posit8 / posit16
  code, 2^16 seeded posit32 codes and an f64 sweep (specials, subnormals,
  both rails) bit for bit against ``repro``'s.
* ``core.formats.FORMATS`` without ``ml_dtypes``: every entry's name, width
  and family, ``minpos`` / ``maxpos`` exactly, its round trip on a
  log-uniform f64 sweep over [1e-45, 1e45] with specials and the OFP8 /
  bf16 double-rounding ties (``ml_dtypes`` goes through f32), and
  ``dynamic_range_decades``, all equal to ``repro``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import avx10 as javx10
from repro.core import formats as jformats
from repro.core import posit_np as jposit
from repro.core import streamline as jstreamline
from repro_torch.core import avx10, formats, posit_np, streamline


def _group_fields(g):
    return (g.gid, g.category, tuple(g.patterns), g.note, tuple(g.instructions))


# ---------------------------------------------------------------------------
# the AVX10.2 tables and the streamlined set
# ---------------------------------------------------------------------------


def test_avx10_groups_and_counts_equal_repro():
    assert [_group_fields(g) for g in avx10.GROUPS] == [_group_fields(g) for g in javx10.GROUPS]
    assert avx10.PAPER_COUNTS == javx10.PAPER_COUNTS
    assert avx10.by_category() == javx10.by_category()
    assert avx10.count_report() == javx10.count_report()
    for pat in ("V(ADD|SUB)(PS|PD)", "KANDN?B", "VMOVNTDQA?", "A(B|C)?D", "V(A|B(C|D)?)E?"):
        assert avx10.expand(pat) == javx10.expand(pat), pat


def test_streamline_tables_and_report_equal_repro():
    assert ([_group_fields(g) for g in streamline.PROPOSED_GROUPS]
            == [_group_fields(g) for g in jstreamline.PROPOSED_GROUPS])
    assert streamline.UNIFICATIONS == jstreamline.UNIFICATIONS
    assert streamline.REMOVED_SPECIALS == jstreamline.REMOVED_SPECIALS
    assert streamline.proposed_by_category() == jstreamline.proposed_by_category()
    assert streamline.streamline_report() == jstreamline.streamline_report()
    # the widening dot products the tiled VDPPT (K4) runs
    pf3 = next(g for g in streamline.PROPOSED_GROUPS if g.gid == "PF3")
    assert {"VDPPT8PT16", "VDPPT16PT32"} <= set(pf3.instructions)


# ---------------------------------------------------------------------------
# posits
# ---------------------------------------------------------------------------


def _f64_sweep(seed=0, size=1 << 15) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(1e-45), np.log(1e45), size)) * rng.choice([-1.0, 1.0], size)
    sp = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-320, -5e-324, 1.7976931348623157e308, 1.0,
          -1.0, 1.0 + 2.0 ** -4 + 2.0 ** -30, 1.0 + 2.0 ** -3 + 2.0 ** -30,
          1.0 + 2.0 ** -8 + 2.0 ** -40, 448.0, 464.0, 57344.0, 61440.0, 65504.0, 65520.0,
          2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 2.0 ** -17, 2.0 ** -24, 2.0 ** -25, 3.4e38, 3.5e38,
          2.0 ** -133, 2.0 ** -134, 1e-300, 1e300, 7.2e16, 1.3e36, 1.4e-17, 7.5e-37]
    return np.concatenate([x, np.array(sp), -np.array(sp)])


def _same_f64(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.uint64), want[ok].view(np.uint64))


@pytest.mark.parametrize("n", (8, 16, 32))
def test_posit_codec_equals_repro(n):
    if n == 32:
        codes = np.random.default_rng(32).integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
        codes = np.concatenate([codes, np.array([0, 1, 1 << 31, (1 << 31) - 1, (1 << 32) - 1],
                                                np.uint64)])
    else:
        codes = np.arange(1 << n, dtype=np.uint64)
    _same_f64(posit_np.decode(codes, n), jposit.decode(codes, n))
    x = _f64_sweep(n)
    got, want = posit_np.encode(x, n), jposit.encode(x, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert posit_np.minpos(n) == jposit.minpos(n) and posit_np.maxpos(n) == jposit.maxpos(n)
    assert posit_np.nar(n) == jposit.nar(n)


# ---------------------------------------------------------------------------
# the figure registry
# ---------------------------------------------------------------------------


def test_figure_registry_names_and_ranges_equal_repro():
    assert list(formats.FORMATS) == list(jformats.FORMATS)
    assert len(formats.FORMATS) == 15
    for name, want in jformats.FORMATS.items():
        got = formats.FORMATS[name]
        assert (got.name, got.nbits, got.family) == (want.name, want.nbits, want.family), name
        assert got.minpos == want.minpos and got.maxpos == want.maxpos, name
        assert formats.dynamic_range_decades(got) == jformats.dynamic_range_decades(want), name


@pytest.mark.parametrize("name", list(jformats.FORMATS))
def test_figure_roundtrip_equals_repro(name):
    x = _f64_sweep(1)
    with np.errstate(all="ignore"):
        want = jformats.FORMATS[name].roundtrip(x)
    _same_f64(formats.FORMATS[name].roundtrip(x), want)


def test_ofp8_roundtrip_rounds_through_f32_as_ml_dtypes():
    """1 + 2^-4 + 2^-30 lies past e4m3's tie at 1 + 2^-4 by less than an f32
    ulp: straight from float64 it rounds up to 1.125, through f32 (as
    ``ml_dtypes`` casts) to the tie's even side, 1.0."""
    x = np.array([1.0 + 2.0 ** -4 + 2.0 ** -30])
    assert formats.FORMATS["ofp8_e4m3"].roundtrip(x)[0] == 1.0
    assert jformats.FORMATS["ofp8_e4m3"].roundtrip(x)[0] == 1.0
