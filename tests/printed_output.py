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


def _max_diff(g: str, w: str) -> float:
    """Largest |difference| between the printed decimal numbers of two
    fields that split into as many tokens (0.0 where none differ)."""
    out = 0.0
    for a, b in zip(g.split(" "), w.split(" ")):
        da, db = _decimal(a), _decimal(b)
        if da is not None and db is not None:
            out = max(out, float(abs(da - db)))
    return out


def _positive(tok: str) -> bool:
    return float(tok) > 0


def compare(got: str, want: str, sign_cols: Sequence[int] = (),
            sam: bool = False) -> Dict[str, object]:
    """Hold ``got`` to ``want`` under the printed-output rule.  Returns
    {"rows": want's line count, "differ": lines not byte-identical,
    "flips": sign changes in sign_cols, "max_diff": the largest difference
    of two printed numbers, "breaches": [messages]}."""
    gl, wl = got.splitlines(), want.splitlines()
    breaches: List[str] = []
    differ = abs(len(gl) - len(wl))
    flips = 0
    max_diff = 0.0
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
        max_diff = max([max_diff] + [_max_diff(a, b) for a, b in zip(gf, wf)])
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
            "max_diff": max_diff, "breaches": breaches}


def assert_agree(got: str, want: str, name: str, **kw) -> Dict[str, object]:
    """compare(), print the counts, and raise on any breach or flip."""
    r = compare(got, want, **kw)
    print(f"{name}: {r['differ']} of {r['rows']} rows differ from the "
          f"reference (printed numbers by at most {r['max_diff']:.6g}), "
          f"{r['flips']} calls flipped, "
          f"{len(r['breaches'])} breaches of the printed-output rule")
    if r["breaches"]:
        raise AssertionError(f"{name}: " + "\n".join(r["breaches"][:10]))
    return r


def table_mode_agree(got: str, want_port: str, want_jax: str, name: str,
                     **kw) -> Dict[str, object]:
    """Hold a port app's output under NPT_LOGSUM=table to the JAX app's:
    identical to its run given the port's transition table (the table
    route is bit for bit the JAX scan's there), and to its run with its
    own table (a few ulp apart, so a lookup may land one 0.001-nat bin
    away) under the printed-output rule, no call flipped."""
    assert got == want_port, (
        f"{name}: differs from the JAX app given the port's transition "
        f"table:\n" + "\n".join(compare(got, want_port, **kw)["breaches"]
                                 [:5]))
    r = assert_agree(got, want_jax, f"{name}, the JAX package's own "
                     f"transition table", **kw)
    assert r["flips"] == 0
    return r


def jax_table_runs(run, monkeypatch):
    """The JAX app's output under NPT_LOGSUM=table (``run()`` returns it)
    given the port's transition table, and with its own."""
    import pytest

    from tests.test_torch_scorereads_phase import _port_transitions_in_jax
    monkeypatch.setenv("NPT_LOGSUM", "table")
    own = run()
    with pytest.MonkeyPatch.context() as mp:
        _port_transitions_in_jax(mp)
        port = run()
    return port, own
