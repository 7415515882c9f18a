"""The comparison that decides ``correct``.

After the window closes, a sample of the reads drawn from the seed (the
longest read, whose ingest sets the program's padded widths and whose
chain is the deepest, and ``check_reads - 1`` others) is worked out again
by the plain reference (``benchmark/reference``) and compared with what
the window's passes printed for them: the first pass's lines against the
reference, every later pass's against the first's.  Each number compared
has its limit in the configuration's file.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

import reference
from reference.common import F32, Precision

from . import generator, spec


def sample(ds: generator.Dataset, n: int, seed: int) -> List[generator.Read]:
    reads = sorted(ds.reads, key=lambda r: (-len(r.basecall), r.name))
    rest = reads[1:]
    pick = np.random.default_rng([seed, 2]).choice(
        len(rest), size=min(n - 1, len(rest)), replace=False)
    return [reads[0]] + [rest[i] for i in sorted(pick.tolist())]


def reference_rows(cell: spec.Cell, ds: generator.Dataset, reads, device,
                   program: Dict[str, List[str]],
                   prec: Precision = F32) -> dict:
    plain = [dict(name=r.name, bam_index=r.bam_index, pos=r.pos, rc=r.rc,
                  basecall=r.basecall, adc=r.adc) for r in reads]
    adc = dict(offset=generator.ADC_OFFSET, range=generator.ADC_RANGE,
               digitisation=generator.DIGITISATION,
               sample_rate=generator.SAMPLE_RATE)
    pairs = {n: cell.app.program_pairs(lines) for n, lines in program.items()}
    return reference.rows(cell.config["app"]["name"], plain, ds.genome,
                          ds.contig, adc,
                          max(len(r.basecall) for r in ds.reads),
                          ds.models_npz, device, guesses=pairs,
                          prec=prec)


def _close(a: str, b: str) -> bool:
    """Two printed fields agree: the same text, or numbers within one unit
    of the last printed place (a rounding of values a few ulps apart)."""
    if a == b:
        return True
    try:
        x, y = float(a), float(b)
    except ValueError:
        return False
    places = len(b.split(".")[1]) if "." in b else 0
    return abs(x - y) <= 10.0 ** -places * 1.000001


def compare(app, prog: Dict[str, List[str]], ref: Dict[str, list]) -> dict:
    """The app's three numbers: the share of rows whose key is on one side
    only, the largest gap of a printed value from the reference's exact
    one, and the share of lines on one side only or differing from the
    other side's line of the same key in a field (numbers by more than
    one unit of their last printed place)."""
    n = diff = tdiff = 0
    gap = 0.0
    for name, rrows in ref.items():
        plines = prog.get(name, [])
        exact, rline = {}, {}
        for line, v in rrows:
            f = line.split("\t")
            key = tuple(f[i] for i in app.KEY_FIELDS)
            exact[key], rline[key] = v, f
        pkeys = set()
        for line in plines:
            f = line.split("\t")
            key = tuple(f[i] for i in app.KEY_FIELDS)
            if key not in exact or key in pkeys:
                diff += 1
                tdiff += 1
                continue
            pkeys.add(key)
            gap = max(gap, abs(float(f[app.VALUE_FIELD]) - exact[key]))
            r = rline[key]
            if len(f) != len(r) or not all(map(_close, f, r)):
                tdiff += 2
        missing = len(exact) - len(pkeys)
        diff += missing
        tdiff += missing
        n += len(rrows) + len(plines)
    n = max(n, 1)
    rows, value, text = app.NAMES
    return {rows: diff / n, value: gap, text: tdiff / n}


def passes_differing(per_pass: List[Dict[str, List[str]]]) -> int:
    """Passes whose lines for the sampled reads differ from the first's."""
    return sum(1 for p in per_pass[1:] if p != per_pass[0])


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the configuration limits is within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: dict, limits: dict, fp=sys.stderr) -> dict:
    """The numbers beside their limits, as the run's last stderr lines and
    as the result line's last key."""
    out = {}
    for k in limits:
        out[k] = {"value": numbers[k], "limit": limits[k]}
        fp.write(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})\n")
    fp.flush()
    return out

