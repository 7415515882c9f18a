"""The window's arithmetic: a closed loop ends with its last whole pass,
and the rate is all passes' work over all of the window; the device's
busy time is the union of its intervals."""

from harness import devtrace, window
from harness.sink import Sink


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_whole_passes_and_ends_with_the_last():
    clk = Clock()
    durations = [3.0, 4.0, 5.0, 6.0]

    def one_pass(i):
        clk.t += durations[i]

    t0, ends = window.run(one_pass, 10.0, clock=clk)
    # passes start at 0, 3 and 7 s (< 10 s); the third ends at 12 s
    assert t0 == 100.0 and ends == [103.0, 107.0, 112.0]
    assert window.rate(1000.0, t0, ends) == 3 * 1000.0 / 12.0


def test_window_runs_at_least_one_pass():
    clk = Clock()

    def one_pass(i):
        clk.t += 50.0

    t0, ends = window.run(one_pass, 10.0, clock=clk)
    assert len(ends) == 1 and window.rate(10.0, t0, ends) == 10.0 / 50.0


def test_idle_share_from_intervals():
    iv = [(0.0, 1.0, "void (anonymous namespace)::viterbi_fill_warp_kernel"
                     "<4>(float const*)"),
          (0.5, 1.5, "chain_step_prepare_kernel(int const*)"),
          (3.0, 3.5, "Memcpy DtoH (Device -> Pinned)"),
          (3.5, 4.0, "void viterbi_fill_warp_kernel<4>(float const*)")]
    assert devtrace.union_seconds(iv) == 2.5
    window_s = 5.0
    assert 1.0 - devtrace.union_seconds(iv) / window_s == 0.5
    names = devtrace.by_name(iv)
    assert names["viterbi_fill_warp_kernel"] == 1.5
    b = devtrace.breakdown(iv)
    assert b["device_ops"][0] == ["viterbi_fill_warp_kernel", 1.5]
    assert b["idle_gaps"][0] == [
        "after chain_step_prepare_kernel, before Memcpy DtoH", 1.5]


def test_sink_keeps_the_sampled_reads_lines():
    sink = Sink(lambda line: line.split("\t")[1], ["r1"])
    for piece in ("contig\tread_", "index\tlevel", "\n"):
        sink.write(piece)
    sink.write("c\tr1\t1\nc\tr1\t2\n")
    sink.write("c\tr2\t3\n")
    sink.write("c\tr2\t4\nc\tr1\t5\n")          # two reads in one call
    assert sink.lines("r1") == ["c\tr1\t1", "c\tr1\t2", "c\tr1\t5"]
    assert sink.lines("r2") == [] and sink.seen == {"r1", "r2"}


def test_card_seconds_and_the_window_rate_from_a_record():
    # kernels alone count for the card's seconds; copies and fills do not
    from harness import spec
    readers = spec.load_cell("cm-longread").readers
    iv = [(0.0, 1.0, "void banded_fill_kernel(float const*)"),
          (0.5, 2.0, "void (anonymous namespace)::forward_fill_warp_kernel"),
          (1.5, 4.0, "Memcpy HtoD (Pageable -> Device)"),
          (9.0, 10.0, "Memset (Device)")]
    rec = dict(app="call-methylation", wall_s=50.0, bases=20e6,
               busy_s=devtrace.union_seconds(iv),
               kernel_busy_s=devtrace.union_seconds(devtrace.kernels(iv)),
               window_s=50.0, kernel_s={})
    assert rec["busy_s"] == 5.0
    assert readers["card_s_per_mb"](rec) == 2.0 / 20.0
    assert readers["cm_window_bases_per_s"](rec) == 20e6 / 50.0
    assert readers["card_s_per_mb"](dict(rec, kernel_busy_s=0.0)) is None
