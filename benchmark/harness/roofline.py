"""The operations and bytes of eventalign's device chain, reckoned from the
chain's own counts of its work (the port's ``CHAIN_STATS``: ``vit_cells``,
``path_steps``, ``live_windows``), and the least time one H100 could take
for them: the larger of the bytes over its HBM bandwidth and the f32
operations over its f32 peak.  A kernel's roofline share is that least
time over the seconds the device trace gives its kernels.

The reckonings are chip_smoke.py's for its kernel checks (``bound``;
phase 3's ``cells * 27`` and ``bt_bytes``; phase 3b's
``chain_round_bytes``), applied to the counts:

  viterbi_fill       27 f32 operations a DP cell; bytes: the trace's byte
                     a cell, 4 a path step (chip_smoke counts 4 an event
                     and 12 a kmer, which the counts do not split; a path
                     holds each event once and no more kmers than the
                     window has, so this is the least), 42 a window
  viterbi_backtrack  5 bytes and 8 operations a path step, 12 bytes a
                     window
  chain_step         chip_smoke's 400,784 bytes a round of 64 windows
                     (each window's levels and kmer rows written, their
                     sources and the path read, its kept rows written,
                     meta and state), a 64th of it a window
"""

from __future__ import annotations

# published peaks of one H100 SXM (dense, no sparsity), at 700 W
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

VIT_OPS_CELL = 27
CHAIN_ROUND_BYTES, CHAIN_ROUND_WINDOWS = 400_784, 64


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for nbytes moved and flops f32 operations."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def viterbi_fill_s(cells: float, steps: float, windows: float) -> float:
    return bound_s(cells + 4.0 * steps + 42.0 * windows, VIT_OPS_CELL * cells)


def viterbi_backtrack_s(steps: float, windows: float) -> float:
    return bound_s(5.0 * steps + 12.0 * windows, 8.0 * steps)


def chain_step_s(windows: float) -> float:
    return bound_s(windows * CHAIN_ROUND_BYTES / CHAIN_ROUND_WINDOWS, 0.0)


def kernel_seconds(rec: dict, prefix: str) -> float:
    """Device seconds of every kernel whose name starts with prefix."""
    return sum(v for k, v in rec["kernel_s"].items() if k.startswith(prefix))


def chain_counts(rec: dict):
    """(vit_cells, path_steps, live_windows) of an eventalign run's chain,
    or None where the run counted none (another app, a program without
    the counters, or no window)."""
    c = rec.get("chain") or {}
    if rec["app"] != "eventalign" or not c.get("live_windows"):
        return None
    return c["vit_cells"], c["path_steps"], c["live_windows"]


def share(bound: float, seconds: float):
    """The bound's share of the kernels' seconds, in %; None without
    seconds."""
    return 100.0 * bound / seconds if seconds > 0 else None
