"""Per-host process launcher: `python -m nanopolish_tpu_torch.parallel.launch`.

Spawns N copies of a nanopolish_tpu_torch subcommand, each with its own
process shard and output file — the programmatic version of the
reference's "makerange | parallel" / watch-suffix-mod-N patterns
(README.md:142-147, call_methylation.cpp:489-508) — and exports the
process-group environment (NPT_COORDINATOR/NPT_NUM_PROCS/NPT_PROC_ID) so
that children join one torch.distributed group (parallel.distributed).

Placeholders `{i}` (process id) and `{n}` (process count) are substituted
into the command args, e.g.:

    python -m nanopolish_tpu_torch.parallel.launch -n 4 \
        --stdout meth.{i}.tsv -- \
        call-methylation -r reads.fq -b a.bam -g ref.fa --shard {i}/{n}

Each child runs on `cuda:(i % device_count)`, or on the CPU when its
command says `--device cpu`.  When a child fails, the launcher kills the
rest at once (a sibling may be waiting for it to join the group) and
exits with the failed child's status.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

# the directory holding the package, put first on the children's path so
# that they run this copy of it
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanopolish_tpu_torch.parallel.launch",
        description="spawn N sharded nanopolish_tpu_torch processes")
    p.add_argument("-n", "--num-processes", type=int, required=True)
    p.add_argument("--coordinator", default="",
                   help="host:port of the torch.distributed rendezvous "
                        "(default: 127.0.0.1:<free port>; 'none' disables)")
    p.add_argument("--stdout", default="",
                   help="per-process stdout file pattern with {i}")
    p.add_argument("--pin-cores", type=int, default=0, metavar="C",
                   help="pin child i to C disjoint CPU cores (cores "
                        "i*C..(i+1)*C-1): keeps per-process host "
                        "resources constant so process scaling is "
                        "measurable on a shared host")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- <subcommand> [args...] ({i}/{n} substituted)")
    return p


def child_argv(args: List[str]) -> List[str]:
    """The command line of one child."""
    return [sys.executable, "-m", "nanopolish_tpu_torch"] + args


def wait_all(procs, timeout: Optional[float] = None,
             poll_s: float = 0.1) -> int:
    """Wait for every child; return the status of the first that fails
    (124 when ``timeout`` seconds pass first), else 0.  The caller kills
    the children still running."""
    deadline = None if timeout is None else time.monotonic() + timeout
    live = list(procs)
    while live:
        for p in list(live):
            code = p.poll()
            if code is not None:
                live.remove(p)
                if code != 0:
                    return code
        if deadline is not None and time.monotonic() > deadline:
            return 124
        if live:
            time.sleep(poll_s)
    return 0


def main(argv: Optional[List[str]] = None,
         timeout: Optional[float] = None) -> int:
    """Run the launch; ``timeout``: seconds after which the children still
    running are killed and the status is 124 (None: no limit)."""
    opt = make_parser().parse_args(argv)
    cmd = opt.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("launch: no command given after --")
    n = opt.num_processes
    coordinator = opt.coordinator
    if coordinator == "":
        coordinator = f"127.0.0.1:{free_port()}"
    path = os.environ.get("PYTHONPATH", "")
    procs = []
    files = []
    try:
        for i in range(n):
            env = dict(os.environ)
            env["NPT_NUM_PROCS"] = str(n)
            env["NPT_PROC_ID"] = str(i)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PKG_PARENT, path) if p)
            if coordinator != "none":
                env["NPT_COORDINATOR"] = coordinator
            args = [a.replace("{i}", str(i)).replace("{n}", str(n))
                    for a in cmd]
            out = None
            if opt.stdout:
                out = open(opt.stdout.replace("{i}", str(i)).replace(
                    "{n}", str(n)), "w")
                files.append(out)
            preexec = None
            if opt.pin_cores:
                cores = set(range(i * opt.pin_cores,
                                  (i + 1) * opt.pin_cores))

                def preexec(cores=cores):  # noqa: E731
                    os.sched_setaffinity(0, cores)
            procs.append(subprocess.Popen(child_argv(args), env=env,
                                          stdout=out, preexec_fn=preexec))
        rc = wait_all(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
