"""The readers of the span metrics: each reads its key of a traced run's
windowed scopes, and gives None for another app or a run without it."""

import pytest

from harness import spec

SPAN_METRICS = {
    "meth_chunk_wait_share": ("meth.wait_chunk", 0.5 / 20.0),
    "cm_main_self_share": ("meth.pass.self", 0.5 / 20.0),
    "signal_load_thread_s_per_mb.cm": ("read_loader.load_raw", 0.5 / 5.0),
    "event_detect_thread_s_per_mb.cm": ("read_builder.detect", 0.5 / 5.0),
    "meth_resolve_thread_s_per_mb": ("meth.resolve", 0.5 / 5.0),
}


def _rec(app, scopes):
    return dict(app=app, wall_s=20.0, bases=5e6, busy_s=1.0,
                kernel_busy_s=1.0, window_s=20.0, kernel_s={},
                scopes=scopes, chain={}, blocked_s=0.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_reader_values_and_none(name):
    read = spec.load_cell("cm-longread").readers[name]
    key, want = SPAN_METRICS[name]
    # every span key at once, each with its own seconds: a reader that
    # read another key would read another value
    scopes = {k: 0.5 if k == key else 7.0
              for k, _ in SPAN_METRICS.values()}
    assert read(_rec("call-methylation", scopes)) == pytest.approx(want)
    assert read(_rec("eventalign", scopes)) is None
    assert read(_rec("call-methylation",
                     {k: v for k, v in scopes.items() if k != key})) is None


def test_span_metrics_are_declared_for_the_cell():
    cell = spec.load_cell("cm-longread")
    declared = {m["name"]: m for m in cell.per_layer}
    for name in SPAN_METRICS:
        m = declared[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["moves"] == "card_s_per_mb"
        assert m["workloads"] == ["cm-longread"]
