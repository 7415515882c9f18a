"""How the benchmark drives ``eventalign`` and judges its output.

A pass is one call of the port's ``apps.eventalign.main`` over the cell's
reads.  On the sampled reads the TSV is compared with the plain
reference's rows: which (position, event, model kmer) rows there are
(``rows_differing``), the scaled event level of each (``level_gap_pa``,
the printed level's largest distance from the reference's exact one) and
each line's text (``text_differing``).
"""

from __future__ import annotations

APP = "eventalign"
KEY_FIELDS = (1, 5, 9)          # position, event_index, model_kmer
VALUE_FIELD = 6                 # event_level_mean
NAMES = ("rows_differing", "level_gap_pa", "text_differing")


def entry():
    from nanopolish_tpu_torch.apps import eventalign
    return eventalign.main


def read_key(line: str, by_index: dict):
    """The read a TSV line belongs to (its read_index column)."""
    return by_index.get(int(line.split("\t", 4)[3]))


def program_pairs(lines):
    """(ref position, event) of each row, in order: the guesses of the
    chain's segment hand-offs that batch the reference's Viterbi."""
    out = []
    for ln in lines:
        f = ln.split("\t", 6)
        out.append((int(f[1]), int(f[5])))
    return out
