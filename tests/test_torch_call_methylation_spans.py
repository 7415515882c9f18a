"""Where the spans sit on call-methylation's pass (``--device cpu``, the
JAX e2e recipe's four reads in chunks of two): the output is the same
byte for byte with NPT_PROFILE on and off, every span of the pass opens
on its thread (main, loader, fetch), and each chunk's wait on the main
thread, its loading and its resolve share one chunk id.  Also
eventalign's root span and the kernels' build and load spans."""

import io
from collections import Counter

import pytest
import torch

from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.apps import eventalign as ea_app
from nanopolish_tpu_torch.utils import cuda_build, profiler
from tests.test_torch_call_methylation import meth_pipeline  # noqa: F401

torch.set_num_threads(2)

# span -> the role of the thread it runs on
ROLES = {
    "meth.pass": "main", "meth.open": "main", "meth.next_batch": "main",
    "meth.wait_chunk": "main", "meth.drain_wait": "main",
    "meth.drain_prep": "main", "meth.write": "main",
    "meth.load_chunk": "loader", "read_loader.load_raw": "loader",
    "read_builder.detect": "loader", "read_builder.assemble": "loader",
    "read_builder.process_chunk": "loader", "meth.collect": "loader",
    "meth.resolve": "fetch",
}


@pytest.fixture
def fresh(monkeypatch):
    for name, value in (("_scopes", {}), ("_self", {}), ("_records", [])):
        monkeypatch.setattr(profiler, name, value)
    monkeypatch.delenv("NPT_PROFILE", raising=False)
    monkeypatch.delenv("NPT_PROFILE_TRACE", raising=False)


def _cm(p, monkeypatch):
    monkeypatch.setattr(cm, "PIPE_CHUNK", 2)
    out = io.StringIO()
    cm.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"],
             "--device", "cpu"], stdout=out)
    return out.getvalue()


def _role(span):
    return profiler._thread_label(span.thread).split("-")[0]


def _traced(monkeypatch, tmp_path):
    monkeypatch.setenv("NPT_PROFILE", "1")
    monkeypatch.setenv("NPT_PROFILE_TRACE", str(tmp_path / "spans.json"))


def test_spans_of_the_pass_on_their_threads(meth_pipeline,  # noqa: F811
                                            fresh, monkeypatch, tmp_path):
    plain = _cm(meth_pipeline, monkeypatch)
    assert profiler.spans() == [] and profiler.snapshot() == {}
    _traced(monkeypatch, tmp_path)
    traced = _cm(meth_pipeline, monkeypatch)
    assert traced == plain and len(plain.splitlines()) > 10
    spans = profiler.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    for name, role in ROLES.items():
        assert name in by_name, name
        assert {_role(s) for s in by_name[name]} == {role}, name
    (root,) = by_name["meth.pass"]
    assert root.parent is None
    for s in spans:
        assert s is root or s.parent is not None, s.name
        assert root.start <= s.start <= s.end <= root.end, s.name
    # no span a read: 4 reads, 2 chunks of 2
    counts = Counter(s.name for s in spans)
    assert counts["meth.wait_chunk"] == counts["meth.load_chunk"] == 2
    assert counts["read_builder.detect"] == counts["read_loader.load_raw"] \
        == 2
    assert max(counts.values()) <= 2 * 2 + 1, counts
    snap = profiler.snapshot()
    assert "meth.pass.self" in snap and "meth.load_chunk.self" in snap
    assert snap["meth.pass.self"][1] <= snap["meth.pass"][1]


def test_a_chunks_spans_share_its_id(meth_pipeline,  # noqa: F811
                                     fresh, monkeypatch, tmp_path):
    _traced(monkeypatch, tmp_path)
    _cm(meth_pipeline, monkeypatch)
    spans = profiler.spans()
    (root,) = [s for s in spans if s.name == "meth.pass"]

    def chunks(name):
        got = [s for s in spans if s.name == name]
        assert len({s.chunk for s in got}) == len(got), name
        return {s.chunk: s for s in got}

    waits = chunks("meth.wait_chunk")
    loads = chunks("meth.load_chunk")
    resolves = chunks("meth.resolve")
    assert len(waits) == 2 and set(waits) == set(loads) == set(resolves)
    assert {c[0] for c in waits} == {root.id}
    assert sorted(c[1] for c in waits) == [0, 1]
    for c in waits:
        assert loads[c].parent is root and resolves[c].parent is root
        assert waits[c].parent is root
        # the loaders' stages nest in their chunk's span on its thread
        inner = [s for s in spans if s.parent is loads[c]]
        assert {s.name for s in inner} >= {"read_loader.load_raw",
                                           "read_builder.detect",
                                           "read_builder.assemble",
                                           "meth.collect"}
        assert all(s.tid == loads[c].tid for s in inner)
        assert resolves[c].start >= loads[c].end
    for s in spans:
        if s.name == "meth.drain_wait":
            assert s.chunk in waits


def test_eventalign_pass_span(meth_pipeline, fresh,  # noqa: F811
                              monkeypatch, tmp_path):
    _traced(monkeypatch, tmp_path)
    out = io.StringIO()
    ea_app.main(["-r", meth_pipeline["fastq"], "-b", meth_pipeline["bam"],
                 "-g", meth_pipeline["ref_fa"], "--device", "cpu"],
                stdout=out)
    spans = profiler.spans()
    (root,) = [s for s in spans if s.name == "ea.pass"]
    assert _role(root) == "main" and root.parent is None
    assert {"read_loader.load_raw", "ea.emit"} <= {s.name for s in spans}
    assert "ea.pass.self" in profiler.snapshot()


class _FakeLib:
    def __getattr__(self, name):
        return type(name, (), {})()


def test_kernel_build_and_load_spans(fresh, monkeypatch, tmp_path):
    """cuda_build's spans without nvcc: nothing stale to build, and every
    library's entry point found through a stand-in for ctypes.CDLL."""
    _traced(monkeypatch, tmp_path)
    monkeypatch.setattr(cuda_build, "_fns", {})
    monkeypatch.setattr(cuda_build, "_stale", lambda name: False)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: _FakeLib())
    assert cuda_build.kernel_fn("forward_fill") is not None
    spans = {s.name: s for s in profiler.spans()}
    assert spans["cuda_build.build"].args == {"kernels": []}
    assert spans["cuda_build.load"].parent is None
    assert set(cuda_build._fns) == set(cuda_build.KERNELS)
