"""CLI driver: subcommand dispatch (reference: src/main/nanopolish.cpp:28-43).

Usage: python -m nanopolish_tpu_torch <subcommand> [args]
"""

from __future__ import annotations

import importlib
import sys

from .models.read_builder import GLOBAL_READ_STATS
from .parallel.distributed import auto_init
from .utils.device import DeviceUnavailable

# each runs apps/<name with "-" as "_">.py's main
SUBCOMMANDS = ("index", "eventalign", "call-methylation", "scorereads",
               "phase-reads", "variants", "vcf2fasta", "polya",
               "detect-polyi", "fast5-check", "methyltrain",
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
    if argv[0] not in SUBCOMMANDS:
        print(f"error: unrecognized command {argv[0]!r}", file=sys.stderr)
        return 1
    app = importlib.import_module(f".apps.{argv[0].replace('-', '_')}",
                                  package="nanopolish_tpu_torch")
    try:
        # a launcher child joins its process group before any work, on
        # the device its app's own parser gives (host-only apps have no
        # --device and run on the cpu)
        opt, _ = app.make_parser().parse_known_args(argv[1:])
        auto_init(device=getattr(opt, "device", "cpu"))
        ret = app.main(argv[1:])
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
