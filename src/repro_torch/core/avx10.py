"""AVX10.2 instruction database, organised as the paper's Tables I-V groups
(the port's own copy of ``repro.core.avx10``, plain Python data and
transforms, held equal to it by ``tests/test_torch_figures.py``).

Each group is written in the paper's compact alternation notation,
``V(ADD|SUB)(PS|PD)``, and expanded to concrete mnemonics by
:func:`expand`.  The paper reports 756 instructions total: 220 bitwise,
59 mask, 107 integer, 363 floating-point and 7 cryptographic.  The published
tables are regex summaries (and partly ambiguous in print), so this module
reconstructs the concrete lists from the AVX10.2 specification structure; the
mask and cryptographic categories reconstruct exactly, the others to within a
few mnemonics (see ``PAPER_COUNTS`` / ``count_report``).

The *proposed* (streamlined, takum-based) instruction set lives in
:mod:`repro_torch.core.streamline`, which applies the paper's Section III rules to
these groups.
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field

__all__ = ["expand", "Group", "GROUPS", "PAPER_COUNTS", "by_category", "count_report"]


def expand(pattern: str) -> list[str]:
    """Expand ``A(B|C)D?(E|F)``-style alternation/optional notation.

    Supports nested parentheses, ``|`` alternation and a trailing ``?`` on a
    parenthesised group (empty alternative).  No other regex features.
    """

    def parse(s: str, i: int) -> tuple[list[str], int]:
        # parses until ')' or end; returns expansions and next index
        alts: list[list[str]] = [[""]]
        while i < len(s):
            ch = s[i]
            if ch == ")":
                return [a for alt in alts for a in alt], i
            if ch == "|":
                alts.append([""])
                i += 1
                continue
            if ch == "(":
                inner, j = parse(s, i + 1)
                assert j < len(s) and s[j] == ")", f"unbalanced parens in {s!r}"
                j += 1
                if j < len(s) and s[j] == "?":
                    inner = inner + [""]
                    j += 1
                alts[-1] = [a + b for a in alts[-1] for b in inner]
                i = j
                continue
            if i + 1 < len(s) and s[i + 1] == "?":  # optional bare char, e.g. N?
                alts[-1] = [a for x in alts[-1] for a in (x + ch, x)]
                i += 2
                continue
            alts[-1] = [a + ch for a in alts[-1]]
            i += 1
        return [a for alt in alts for a in alt], i

    out, i = parse(pattern.replace(" ", ""), 0)
    assert i == len(pattern.replace(" ", "")), f"trailing input in {pattern!r}"
    # dedupe preserving order
    seen, res = set(), []
    for m in out:
        if m not in seen:
            seen.add(m)
            res.append(m)
    return res


@dataclass(frozen=True)
class Group:
    gid: str  # paper group id, e.g. "B01", "F07"
    category: str  # bitwise | mask | integer | fp | crypto
    patterns: tuple[str, ...]  # AVX10.2 alternation patterns
    note: str = ""

    @property
    def instructions(self) -> list[str]:
        out = []
        for p in self.patterns:
            out.extend(expand(p))
        return out


# Paper-reported totals (Section IV).
PAPER_COUNTS = {"bitwise": 220, "mask": 59, "integer": 107, "fp": 363, "crypto": 7}

_FMA_ORD = "(132|213|231)"

GROUPS: list[Group] = [
    # ----------------------------------------------------------------- bitwise
    Group(
        "B01",
        "bitwise",
        (
            "V(ALIGN|PCONFLICT|PLZCNT|PTERNLOG)(D|Q)",
            "VP(GATHER|SCATTER)(D|Q)(D|Q)",
            "VPRO(L|R)V?(D|Q)",
        ),
        "32/64-bit lane ops on integer registers",
    ),
    Group(
        "B02",
        "bitwise",
        (
            "V(ANDN?|BLENDM|COMPRESS|EXPAND)P(S|D)",
            "VCVTUSI2S(S|D)",  # bit-preserving moves counted w/ fp registers
            "VPEXTR(B|W|D|Q)",
            "VPINSR(B|W|D|Q)",
            "V(GATHER|SCATTER)(D|Q)P(S|D)",
            "VPBLENDM(B|W|D|Q)",
            "VPCOMPRESS(B|W|D|Q)",
            "VPEXPAND(B|W|D|Q)",
            "VPERM(B|W|D|Q)",
            "VPERM(I2|T2)(B|W|D|Q)",
            "VPERM(I2|T2)?P(S|D)",
            "VPERMIL(PS|PD)",
            "VPTESTN?M(B|W|D|Q)",
            "VRANGE(P|S)(S|D)",
            "VSHUFP(S|D)",
            "VUNPCK(L|H)P(S|D)",
            "VX?ORP(S|D)",
        ),
        "float-register bitwise/permute family (paper folds these with B01)",
    ),
    Group(
        "B03",
        "bitwise",
        (
            "VMOV(D|S(L|H))DUP",
            "VMOV(LH|HL)PS",
            "VMOV(L|H|A|U|NT)P(S|D)",
            "VMOVS(H|S|D)",
            "VMOVD",
            "VMOVQ",
            "VMOVW",
            "VMOVDQ(A(32|64)?|U(8|16|32|64)?)",
            "VMOVNTDQA?",
        ),
        "moves/duplicates",
    ),
    Group("B04", "bitwise", ("VBROADCAST(F|I)(32X(2|4|8)|64X(2|4))", "VBROADCASTS(S|D)"), ""),
    Group("B05", "bitwise", ("VPBROADCAST(B|W|D|Q)", "VPBROADCASTM(B2Q|W2D)"), ""),
    Group(
        "B06",
        "bitwise",
        ("V(EXTRACT|INSERT)(F|I)(32X4|32X8|64X2|64X4)", "V(EXTRACT|INSERT)PS"),
        "",
    ),
    Group("B07", "bitwise", ("VSHUF(F|I)(32X4|64X2)",), ""),
    Group("B08", "bitwise", ("VPSHUF(B|HW|LW|D|BITQMB)",), ""),
    Group("B09", "bitwise", ("VPS(L|R)L(D|DQ|Q|VD|VQ|VW|W)",), "logical shifts"),
    Group("B10", "bitwise", ("VPSRA(D|Q|VD|VQ|VW|W)",), "arithmetic shifts"),
    Group("B11", "bitwise", ("VPUNPCK(H|L)(BW|WD|DQ|QDQ)",), ""),
    Group(
        "B12",
        "bitwise",
        ("VP(ALIGNR|ANDN?|MULTISHIFTQB|OPCNT|SH(L|R)DV?|X?OR)",),
        "lane-size-free group; unchanged by the proposal",
    ),
    # -------------------------------------------------------------------- mask
    Group(
        "M01",
        "mask",
        ("K(ADD|ANDN?|MOV|NOT|OR(TEST)?|SHIFTL|SHIFTR|TEST|XN?OR)(B|W|D|Q)",),
        "",
    ),
    Group("M02", "mask", ("KUNPCK(BW|WD|DQ)",), ""),
    Group("M03", "mask", ("VPMOV(B|W|D|Q)2M",), ""),
    Group("M04", "mask", ("VPMOVM2(B|W|D|Q)",), ""),
    # ----------------------------------------------------------------- integer
    Group("I01", "integer", ("V(DBP|MP|P)SADBW",), ""),
    Group(
        "I02",
        "integer",
        ("VP(ABS|ADD|CMP|CMPEQ|CMPGT|CMPU|MAXS|MAXU|MINS|MINU|SUB)(B|W|D|Q)",),
        "",
    ),
    Group("I03", "integer", ("VP(ADDU?S|AVG|SUBU?S)(B|W)",), "saturating/avg 8/16-bit"),
    Group("I04", "integer", ("VPACK(S|U)S(DW|WB)",), ""),
    Group("I05", "integer", ("VPCLMULQDQ",), "carry-less multiply"),
    Group("I06", "integer", ("VPDP(B|W)(S|U)(S|U)DS?",), "VNNI dot products"),
    Group("I07", "integer", ("VPMADD(52(L|H)UQ|UBSW|WD)",), ""),
    Group(
        "I08",
        "integer",
        ("VPMOV(WB|DB|DW|QB|QW|QD)", "VPMOV(S|Z)X(BW|BD|BQ|WD|WQ|DQ)"),
        "width conversions",
    ),
    Group("I09", "integer", ("VPMUL(DQ|H(RS)?W|HUW|L(W|D|Q)|UDQ)",), ""),
    # ---------------------------------------------------------------------- fp
    Group(
        "F01",
        "fp",
        (
            f"V(ADD|FN?M(ADD|SUB){_FMA_ORD}|MINMAX|MUL|REDUCE|RNDSCALE|SQRT|SUB)"
            "(NEPBF16|(P|S)(H|S|D))",
        ),
        "arithmetic core: 18 ops x 7 format suffixes",
    ),
    Group("F02", "fp", ("V(FIXUPIMM|RANGE)(P|S)(S|D)",), ""),
    Group(
        "F03",
        "fp",
        (
            "V(CMP|FPCLASS|GET(EXP|MANT)|MIN|MAX|SCALEF)(PBF16|(P|S)(H|S|D))",
            "VCOMSBF16",
        ),
        "",
    ),
    Group(
        "F04",
        "fp",
        (
            f"V(U?COM(I|X)S|DIV(P|S)|FM(ADDSUB|SUBADD){_FMA_ORD}P)(H|S|D)",
            "VDIVNEPBF16",
        ),
        "",
    ),
    Group("F05", "fp", ("VFC?(MADD|MUL)C(P|S)H",), "complex fp16"),
    Group("F06", "fp", ("VR(CP|SQRT)(14(P|S)(S|D)|P(BF16|H)|SH)",), ""),
    Group(
        "F07",
        "fp",
        (
            # --- 8-bit float conversions (AVX10.2 additions)
            "VCVT(BIAS|NE2?)PH2(B|H)F8S?",
            "VCVTHF82PH",
            "VCVT2PS2PHX",
            # --- bfloat16
            "VCVTNE2?PS2BF16",
            "VCVT(T?)NEBF162IU?BS",
            # --- packed int <-> fp (incl. AVX10.2 saturating ...S forms)
            "VCVT(T?)P(D|H|S)2(DQ|QQ|UDQ|UQQ)",
            "VCVTTP(D|S)2(DQ|QQ|UDQ|UQQ)S",
            "VCVT(T?)P(H|S)2IU?BS",
            "VCVTPH2U?W",
            "VCVTTPH2U?W",
            "VCVT(U?)(DQ|QQ)2P(H|S|D)",
            "VCVTU?W2PH",
            # --- packed fp <-> fp
            "VCVTPD2P(H|S)",
            "VCVTPH2P(S|SX|D)",
            "VCVTPS2P(D|HX?)",
            # --- scalar fp <-> fp
            "VCVTSD2S(H|S)",
            "VCVTSH2S(D|S)",
            "VCVTSS2S(D|H)",
            # --- scalar int <-> fp (incl. saturating T...S forms)
            "VCVTS(D|H|S)2U?SI",
            "VCVTTS(D|H|S)2U?SIS?",
            "VCVTU?SI2S(D|H|S)",
        ),
        "conversion family (the paper's main simplification target)",
    ),
    Group("F08", "fp", ("VDP(BF16|PH)PS",), "widening dot products"),
    # ------------------------------------------------------------------ crypto
    Group("C01", "crypto", ("VAES(DEC|ENC)(LAST)?",), ""),
    Group("C02", "crypto", ("VGF2P8AFFINE(INV)?QB",), ""),
    Group("C03", "crypto", ("VGF2P8MULB",), ""),
]


def by_category() -> dict[str, list[str]]:
    cats: dict[str, list[str]] = {}
    for g in GROUPS:
        cats.setdefault(g.category, []).extend(g.instructions)
    return cats


def count_report() -> dict[str, dict]:
    """Per-category counts: reconstructed here vs reported in the paper."""
    cats = by_category()
    rep = {}
    for cat, names in cats.items():
        assert len(names) == len(set(names)), f"duplicate mnemonics in {cat}"
        rep[cat] = {
            "reconstructed": len(names),
            "paper": PAPER_COUNTS[cat],
            "delta": len(names) - PAPER_COUNTS[cat],
        }
    rep["total"] = {
        "reconstructed": sum(len(v) for v in cats.values()),
        "paper": sum(PAPER_COUNTS.values()),
        "delta": sum(len(v) for v in cats.values()) - sum(PAPER_COUNTS.values()),
    }
    return rep
