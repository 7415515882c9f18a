"""The output sink a pass writes into, in place of a file.

It notes which reads a pass printed rows for and keeps only what the
check needs: the lines of the sampled reads.  It skips the header line,
which the apps write in pieces, up to its newline.  The apps write one
read's rows in one call, so the sink looks at a call's first and last
lines; a call that holds several reads is split line by line.  Nothing
goes to disk.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, List


class Sink:
    def __init__(self, key: Callable[[str], object], keep: Iterable):
        self.key = key
        self.keep = set(keep)
        self.in_header = True        # the header line comes in pieces
        self.seen = set()
        self.kept: Dict[object, List[str]] = defaultdict(list)

    def write(self, s: str) -> int:
        if self.in_header:
            self.in_header = "\n" not in s
            return len(s)
        if not s:
            return 0
        first_end = s.find("\n")
        first = s if first_end < 0 else s[:first_end]
        last_start = s.rfind("\n", 0, len(s) - 1) + 1
        last = s[last_start:].rstrip("\n")
        k0 = self.key(first)
        if k0 == self.key(last):
            self.seen.add(k0)
            if k0 in self.keep:
                self.kept[k0].append(s)
            return len(s)
        for line in s.splitlines():
            k = self.key(line)
            self.seen.add(k)
            if k in self.keep:
                self.kept[k].append(line + "\n")
        return len(s)

    def flush(self):
        pass

    def lines(self, k) -> List[str]:
        return "".join(self.kept.get(k, [])).splitlines()
