"""The printed-output rule: how a Forward-scored text output of the port is
held to the reference's.

Forward scores (logaddexp) are not bit-reproducible across two
implementations of exp/log1p, so the port's TSV/SAM output may differ from
the reference's in the last printed digit.  Two outputs agree when, line
for line:

  * non-numeric fields are identical (names, sequences, the modbam ``Mm``
    tag, SAM SEQ);
  * every printed decimal number is within one unit of its last printed
    digit, and integers are identical, except the modbam ``Ml`` values
    and the SAM QUAL characters, which may differ by one;
  * no call flips: the sign of the columns named in ``sign_cols`` (the
    methylation log-likelihood ratio) is the same.

``compare`` counts the rows that differ at all and lists every breach.
"""

from __future__ import annotations

from decimal import Decimal, InvalidOperation
from typing import Dict, List, Sequence

SAM_QUAL = 10


def _decimal(tok: str):
    """A finite printed decimal number (with '.' or an exponent), else None."""
    if not any(c in tok for c in ".eE"):
        return None
    try:
        d = Decimal(tok)
    except InvalidOperation:
        return None
    return d if d.is_finite() else None


def _token_ok(g: str, w: str) -> bool:
    if g == w:
        return True
    dg, dw = _decimal(g), _decimal(w)
    if dg is None or dw is None:
        return False
    unit = Decimal(1).scaleb(max(dg.as_tuple().exponent,
                                 dw.as_tuple().exponent))
    return abs(dg - dw) <= unit


def _field_ok(g: str, w: str, col: int, sam: bool) -> bool:
    if g == w:
        return True
    if g.startswith("Ml:B:C,") and w.startswith("Ml:B:C,"):
        gv, wv = g.split(",")[1:], w.split(",")[1:]
        return len(gv) == len(wv) and all(
            abs(int(a) - int(b)) <= 1 for a, b in zip(gv, wv) if a or b)
    if sam and col == SAM_QUAL:
        return len(g) == len(w) and all(
            abs(ord(a) - ord(b)) <= 1 for a, b in zip(g, w))
    gt, wt = g.split(" "), w.split(" ")
    return len(gt) == len(wt) and all(_token_ok(a, b)
                                      for a, b in zip(gt, wt))


def _positive(tok: str) -> bool:
    return float(tok) > 0


def compare(got: str, want: str, sign_cols: Sequence[int] = (),
            sam: bool = False) -> Dict[str, object]:
    """Hold ``got`` to ``want`` under the printed-output rule.  Returns
    {"rows": want's line count, "differ": lines not byte-identical,
    "flips": sign changes in sign_cols, "breaches": [messages]}."""
    gl, wl = got.splitlines(), want.splitlines()
    breaches: List[str] = []
    differ = abs(len(gl) - len(wl))
    flips = 0
    if len(gl) != len(wl):
        breaches.append(f"{len(gl)} lines, expected {len(wl)}")
    for i, (g, w) in enumerate(zip(gl, wl)):
        if g == w:
            continue
        differ += 1
        gf, wf = g.split("\t"), w.split("\t")
        if len(gf) != len(wf):
            breaches.append(f"line {i + 1}: field count\n  {g}\n  {w}")
            continue
        bad = [c for c, (a, b) in enumerate(zip(gf, wf))
               if not _field_ok(a, b, c, sam)]
        for c in sign_cols:
            if c < len(wf) and _decimal(wf[c]) is not None and \
                    _decimal(gf[c]) is not None and \
                    _positive(gf[c]) != _positive(wf[c]):
                flips += 1
                bad.append(c)
        if bad:
            breaches.append(f"line {i + 1}: fields {sorted(set(bad))}\n"
                            f"  {g}\n  {w}")
    return {"rows": len(wl), "differ": differ, "flips": flips,
            "breaches": breaches}


def assert_agree(got: str, want: str, name: str, **kw) -> Dict[str, object]:
    """compare(), print the counts, and raise on any breach or flip."""
    r = compare(got, want, **kw)
    print(f"{name}: {r['differ']} of {r['rows']} rows differ from the "
          f"reference, {r['flips']} calls flipped, "
          f"{len(r['breaches'])} breaches of the printed-output rule")
    if r["breaches"]:
        raise AssertionError(f"{name}: " + "\n".join(r["breaches"][:10]))
    return r
