"""`fast5-check` subcommand: signal-file I/O diagnostics.

Rebuild of fast5_check_main (reference:
src/nanopolish_fast5_check.cpp:105-149): open every signal file in the
readdb, read channel params + raw samples, print OK/ERROR per read.
Host only.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, TextIO

from ..io import fast5 as f5
from ..io.readdb import ReadDB
from ..io.slow5 import Slow5File


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nanopolish_tpu_torch fast5-check",
                                description="check the signal files in the readdb")
    p.add_argument("-r", "--reads", required=True)
    return p


def main(argv: Optional[List[str]] = None, stdout: Optional[TextIO] = None):
    opt = make_parser().parse_args(argv)
    out = stdout if stdout is not None else sys.stdout

    db = ReadDB()
    db.load(opt.reads)
    slow5_cache = {}
    n_ok = 0
    n_err = 0
    for name in db.get_all_read_names():
        path = db.get_signal_path(name)
        status = "ERROR"
        detail = ""
        if not path:
            detail = "no signal path"
        elif path.endswith((".slow5", ".blow5")):
            try:
                sf = slow5_cache.get(path)
                if sf is None:
                    sf = slow5_cache[path] = Slow5File(path)
                rec = sf.get_read(name)
                if rec is not None and rec.len_raw_signal > 0:
                    status = "OK"
                else:
                    detail = "read not found in slow5"
            except Exception as e:
                detail = str(e)
        else:
            data = f5.load_read(path, name)
            if data.is_valid and len(data.rt) > 0:
                status = "OK"
            else:
                detail = "could not load raw samples"
        if status == "OK":
            n_ok += 1
        else:
            n_err += 1
        suffix = f" ({detail})" if detail else ""
        out.write(f"{status}\t{name}\t{path}{suffix}\n")
    print(f"[fast5-check] {n_ok} reads ok, {n_err} errors", file=sys.stderr)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
