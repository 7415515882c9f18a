"""IUPAC nucleotide ambiguity codes (reference: src/common/nanopolish_iupac.*)."""

IUPAC_POSSIBLE = {
    "A": "A",
    "C": "C",
    "G": "G",
    "T": "T",
    "M": "AC",
    "R": "AG",
    "W": "AT",
    "S": "CG",
    "Y": "CT",
    "K": "GT",
    "V": "ACG",
    "H": "ACT",
    "D": "AGT",
    "B": "CGT",
    "N": "ACGT",
}

UNAMBIGUOUS = set("ACGT")


def is_unambiguous(c: str) -> bool:
    return c in UNAMBIGUOUS


def is_ambiguous(c: str) -> bool:
    return c in IUPAC_POSSIBLE and c not in UNAMBIGUOUS


def is_valid(c: str) -> bool:
    return c in IUPAC_POSSIBLE


def get_possible_symbols(c: str) -> str:
    return IUPAC_POSSIBLE[c]
