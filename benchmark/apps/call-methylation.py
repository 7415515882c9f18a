"""How the benchmark drives ``call-methylation`` and judges its output.

A pass is one call of the port's ``apps.call_methylation.main`` over the
cell's reads.  On the sampled reads the TSV is compared with the plain
reference's rows: which sites there are (``sites_differing``), each
site's log-likelihood ratio (``llr_gap``, the printed ratio's largest
distance from the reference's exact one) and each line's text
(``text_differing``).
"""

from __future__ import annotations

APP = "call-methylation"
KEY_FIELDS = (0, 1, 2, 3)       # chromosome, strand, start, end
VALUE_FIELD = 5                 # log_lik_ratio
NAMES = ("sites_differing", "llr_gap", "text_differing")


def entry():
    from nanopolish_tpu_torch.apps import call_methylation
    return call_methylation.main


def read_key(line: str, by_index: dict):
    """The read a TSV line belongs to (its read_name column)."""
    return line.split("\t", 5)[4]


def program_pairs(lines):
    return None
