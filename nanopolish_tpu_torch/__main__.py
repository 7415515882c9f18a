"""CLI driver: subcommand dispatch (reference: src/main/nanopolish.cpp:28-43).

Usage: python -m nanopolish_tpu_torch <subcommand> [args]
"""

from __future__ import annotations

import sys

from .models.read_builder import GLOBAL_READ_STATS
from .utils.device import DeviceUnavailable


def _lazy(name):
    def run(argv):
        import importlib
        mod = importlib.import_module(f".apps.{name}",
                                      package="nanopolish_tpu_torch")
        return mod.main(argv)
    return run


SUBCOMMANDS = {
    "index": _lazy("index"),
    "eventalign": _lazy("eventalign"),
    "call-methylation": _lazy("call_methylation"),
    "scorereads": _lazy("scorereads"),
    "phase-reads": _lazy("phase_reads"),
    "variants": _lazy("variants"),
    "vcf2fasta": _lazy("vcf2fasta"),
}

# subcommands of nanopolish_tpu that this package does not run yet
NOT_PORTED = ("methyltrain", "polya", "detect-polyi", "fast5-check",
              "train-poremodel-from-basecalls")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: nanopolish_tpu_torch <command> [options]\n\ncommands:",
              file=sys.stderr)
        for name in SUBCOMMANDS:
            print(f"  {name}", file=sys.stderr)
        return 0 if argv else 1
    if argv[0] == "--version":
        from . import __version__
        print(f"nanopolish_tpu_torch {__version__}")
        return 0
    if argv[0] in NOT_PORTED:
        print(f"error: {argv[0]} is not yet ported to nanopolish_tpu_torch",
              file=sys.stderr)
        return 2
    cmd = SUBCOMMANDS.get(argv[0])
    if cmd is None:
        print(f"error: unrecognized command {argv[0]!r}", file=sys.stderr)
        return 1
    try:
        ret = cmd(argv[1:])
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    # post-run read QC summary (src/main/nanopolish.cpp:87-97)
    report = GLOBAL_READ_STATS.report()
    if report:
        print(report, file=sys.stderr)
    return ret


if __name__ == "__main__":
    sys.exit(main())
