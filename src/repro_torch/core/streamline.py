"""The paper's Section III streamlining methodology, as an executable transform
(the port's own copy of ``repro.core.streamline``, held equal to it by
``tests/test_torch_figures.py``).

Four rules applied to the AVX10.2 database (:mod:`repro_torch.core.avx10`):

  1. *Instruction grouping* — categories bitwise/mask/integer/fp/crypto.
  2. *Bit-quantity naming* — B/W/D/Q suffixes become B8/B16/B32/B64 for raw
     bits, U8../S8.. for unsigned/signed integers (scalable past 64 bits).
  3. *Floating-point naming* — every IEEE-754-derived format suffix
     (H/S/D, PBF16/NEPBF16, BF8/HF8) is replaced by takum T8/T16/T32/T64;
     format-special instructions (biased OFP8 converts, NE-suffixed bfloat16
     ops, complex-fp16-only ops) disappear as instructions, their function
     being covered by the uniform family.
  4. *Generalisation* — ops formerly limited to some precisions are extended
     to the full 8/16/32/64 range (justified by the shared takum decoder).

Outputs: the proposed instruction set (Tables I-V right-hand columns),
the group-unification map, and the removed-special-case list.  The takum
instruction *semantics* live in :mod:`repro_torch.core.isa`.
"""

from __future__ import annotations

from dataclasses import dataclass

from .avx10 import GROUPS, Group, expand

__all__ = [
    "PROPOSED_GROUPS",
    "UNIFICATIONS",
    "REMOVED_SPECIALS",
    "proposed_by_category",
    "streamline_report",
]

_B4 = "B(8|16|32|64)"
_W4 = "(8|16|32|64)"
_T4 = "T(8|16|32|64)"

# ---------------------------------------------------------------------------
# Proposed instruction set (right-hand columns of Tables I-V)
# ---------------------------------------------------------------------------

PROPOSED_GROUPS: list[Group] = [
    # B01-B03 unify: every value-oriented bitwise op over B8..B64 lanes
    Group(
        "PB1",
        "bitwise",
        (
            f"V(ALIGN|ANDN?P|BLENDMP|COMPRESSP|CVTUS2S|EXPANDP|EXTR|INSR)" + _B4,
            f"V(GATHER|SCATTER)B(32|64)P" + _B4,
            f"VMOV(NT)?P" + _B4,
            f"VP(BLENDM|COMPRESS|CONFLICT|EXPAND|LZCNT)" + _B4,
            f"VPERM(I2|T2)?" + _B4,
            f"VPERM(IL|I2|T2)?P" + _B4,
            f"VP(GATHER|SCATTER)B(32|64)" + _B4,
            f"VPRO(L|R)V?" + _B4,
            f"VPTERNLOG" + _B4,
            f"VPTESTN?M" + _B4,
            f"VRANGE(P|S)" + _B4,
            f"V(SHUFP|UNPCK(L|H)P|X?ORP)" + _B4,
        ),
        "unifies B01+B02+B03 (value ops, any lane width)",
    ),
    # B04-B11 unify: every shape/layout op over B8..B256 blocks
    Group(
        "PB2",
        "bitwise",
        ("V(BROADCAST|EXTRACT|INSERT|P?SHUF|PS(L|R)L|PSRA|PUNPCK(H|L))B(8|16|32|64|128|256)",),
        "unifies B04..B11 (shape ops, block widths up to 256)",
    ),
    Group(
        "PB3",
        "bitwise",
        ("VP(ALIGNR|ANDN?|MULTISHIFTQB|OPCNT|SH(L|R)DV?|X?OR)",),
        "B12 unchanged",
    ),
    # ---- mask: pure renames
    Group("PM1", "mask", (f"K(ADD|ANDN?|MOV|NOT|OR(TEST)?|SHIFTL|SHIFTR|TEST|XN?OR){_B4}",), ""),
    Group("PM2", "mask", ("VKUNPCK(B8B16|B16B32|B32B64)",), ""),
    Group("PM3", "mask", (f"VPMOV{_B4}2M",), ""),
    Group("PM4", "mask", (f"VPMOVM2{_B4}",), ""),
    # ---- integer: explicit signedness + systematic widths
    Group("PI1", "integer", ("V(DBP|MP|P)SADU8U16",), "I01 renamed"),
    Group(
        "PI2",
        "integer",
        (
            f"VP(ABSS|ADD(U|S)|CMPEQU|CMPGTS|CMP(U|S)|MAX(S|U)|MIN(S|U)|SUB(U|S)){_W4}",
            f"VP(ADDSAT(U|S)|AVGU|SUBSAT(U|S)){_W4}",
        ),
        "I02+I03 merged: signedness always explicit, saturating ops all widths",
    ),
    Group("PI3", "integer", ("VPACK(S|U)(S32S16|S16S8)",), "I04 renamed"),
    Group("PI4", "integer", ("VPCLMULS64",), "I05 renamed"),
    Group("PI5", "integer", ("VPDP(U8|U16)(S|U)(S|U)DS?",), "I06 renamed"),
    Group("PI6", "integer", ("VPMADD(52(L|H)U64|U8S16|S16S32)",), "I07 renamed"),
    Group(
        "PI7",
        "integer",
        ("VPMOV(S16S8|S32S8|S32S16|S64S8|S64S16|S64S32)", "VPMOV(S|Z)X(S8S16|S8S32|S8S64|S16S32|S16S64|S32S64)"),
        "I08 renamed",
    ),
    Group("PI8", "integer", (f"VPMUL(L|H)?U{_W4}",), "I09 systematised"),
    # ---- fp: one uniform takum family replaces F01-F06
    Group(
        "PF1",
        "fp",
        (
            "V(ADD|CLASS|DIV|EXP|FC?(MADD|MUL)C|FIXUPIMM"
            "|FM(ADDSUB|SUBADD)(132|213|231)|FN?M(ADD|SUB)(132|213|231)"
            "|MANT|MAX|MIN|MINMAX|MUL|RANGE|R(CP|SQRT)|REDUCE|RNDSCALE"
            f"|SCALE|SQRT|SUB|U?CMP)(P|S){_T4}",
        ),
        "unifies F01..F06: every op x packed/scalar x T8/T16/T32/T64",
    ),
    # ---- conversions: int<->takum and takum<->takum, fully orthogonal
    Group(
        "PF2",
        "fp",
        (
            f"VCVTP(S|U){_W4}2P{_T4}",
            f"VCVTS(S|U){_W4}2S{_T4}",
            f"VCVTP{_T4}2P(S|U){_W4}",
            f"VCVTS{_T4}2S(S|U){_W4}",
            "VCVT(PT8|PT16|PT32|PT64)2(PT8|PT16|PT32|PT64)",
            "VCVT(ST8|ST16|ST32|ST64)2(ST8|ST16|ST32|ST64)",
        ),
        "replaces F07: orthogonal conversion matrix, no biased/NE special cases",
    ),
    # ---- widening dot products (the ML hot path; Pallas kernels implement these)
    Group("PF3", "fp", ("VDP(PT8PT16|PT16PT32|PT32PT64)",), "replaces F08"),
    # ---- crypto renames
    Group("PC1", "crypto", ("VAES(DEC|ENC)(LAST)?",), ""),
    Group("PC2", "crypto", ("VGF2P8AFFINE(INV)?U64U8",), ""),
    Group("PC3", "crypto", ("VGF2P8MULU8",), ""),
]

# Which original groups each proposed group covers (the paper's unification claims)
UNIFICATIONS = {
    "PB1": ("B01", "B02", "B03"),
    "PB2": ("B04", "B05", "B06", "B07", "B08", "B09", "B10", "B11"),
    "PB3": ("B12",),
    "PM1": ("M01",),
    "PM2": ("M02",),
    "PM3": ("M03",),
    "PM4": ("M04",),
    "PI1": ("I01",),
    "PI2": ("I02", "I03"),
    "PI3": ("I04",),
    "PI4": ("I05",),
    "PI5": ("I06",),
    "PI6": ("I07",),
    "PI7": ("I08",),
    "PI8": ("I09",),
    "PF1": ("F01", "F02", "F03", "F04", "F05", "F06"),
    "PF2": ("F07",),
    "PF3": ("F08",),
    "PC1": ("C01",),
    "PC2": ("C02",),
    "PC3": ("C03",),
}

# Format-special-case instructions that simply cease to exist under takum
# (rule 3): biased OFP8 conversions, NE ("no exception") bfloat16 arithmetic,
# per-format duplicated conversion paths.
REMOVED_SPECIALS = sorted(
    set(
        expand("VCVTBIASPH2(B|H)F8S?")
        + expand("VCVTNE2?PH2(B|H)F8S?")
        + expand("VCVTNE2?PS2BF16")
        + expand("V(ADD|SUB|MUL|DIV|FN?M(ADD|SUB)(132|213|231))NEPBF16")
        + expand("VCVT(T?)NEBF162IU?BS")
        + expand("VCVTHF82PH")
        + expand("VCVT2PS2PHX")
    )
)


def proposed_by_category() -> dict[str, list[str]]:
    cats: dict[str, list[str]] = {}
    for g in PROPOSED_GROUPS:
        cats.setdefault(g.category, []).extend(g.instructions)
    return cats


def streamline_report() -> dict:
    """Before/after metrics for the benchmark (Tables I-V summary)."""
    from .avx10 import by_category

    before, after = by_category(), proposed_by_category()
    fmt_suffixes_before = {"PH", "PS", "PD", "SH", "SS", "SD", "PBF16", "NEPBF16", "BF8", "HF8", "BF16"}
    rep = {
        "groups_before": len(GROUPS),
        "groups_after": len(PROPOSED_GROUPS),
        "counts_before": {k: len(v) for k, v in before.items()},
        "counts_after": {k: len(v) for k, v in after.items()},
        "fp_formats_before": sorted(fmt_suffixes_before),
        "fp_formats_after": ["T8", "T16", "T32", "T64"],
        "removed_specials": len(REMOVED_SPECIALS),
        "unifications": {k: list(v) for k, v in UNIFICATIONS.items() if len(v) > 1},
    }
    return rep
