"""call-methylation's object path (``NPT_METH_ARRAY=0``) and its switches
on the port, against the JAX package's object path and the port's own
array path.

The object path builds an HMMInputSequence pair per motif group
(``collect_read_tasks``) and scores a chunk through ``ScoreBatcher``'s
indexed drain (``ops/profile_hmm_indexed``), where the array path runs the
flat Forward: on the card two different kernels, here their plain
versions.  Against the JAX app the rows are held to the printed-output
rule (tests/printed_output.py); against the port's array path byte for
byte, as tests/test_call_methylation_e2e.py:273-327 holds the JAX
package's two routes.  The corpora are tests/test_torch_call_methylation's:
the JAX e2e recipe and the straddle corpus, whose groups take the
per-window methylate branch.
"""

import io

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.utils.syncstats import SYNC_STATS
from nanopolish_tpu_torch.utils.synthetic import random_sequence
from tests.printed_output import assert_agree
from tests.test_torch_call_methylation import LLR, _args, _corpus, _render_bam

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meth_pipeline(tmp_path_factory):
    """The JAX e2e recipe (tests/test_call_methylation_e2e.py:24-74)."""
    rng = np.random.default_rng(11)
    genome = random_sequence(rng, 2000)
    plan = [("m0", 100, False, True, 450), ("m1", 700, True, True, 450),
            ("u0", 400, False, False, 450), ("u1", 1100, True, False, 450)]
    return _corpus(tmp_path_factory.mktemp("torch_meth_obj"), rng, genome,
                   plan, shift=0.0, leader=500)


@pytest.fixture(scope="module")
def straddle_pipe(tmp_path_factory):
    """CpGs spaced min_separation+1 apart (tests/test_call_methylation_e2e.py
    :295-324): every window has a motif one base outside it."""
    rng = np.random.default_rng(23)
    genome = ("ATCAAT" * 10) + "ATTGATAGACG" * 60 + ("TTAGCA" * 10)
    plan = [("s0", 0, False, True, 400), ("s1", 150, True, False, 400),
            ("s2", 300, False, True, 400)]
    return _corpus(tmp_path_factory.mktemp("torch_meth_obj_straddle"), rng,
                   genome, plan, shift=0.0, leader=500)


@pytest.fixture(scope="module")
def array_tsv():
    """The port's array path (the default), 3 reads a chunk, per corpus."""
    cache = {}

    def get(p):
        if p["bam"] not in cache:
            cache[p["bam"]] = _port(p, {})
        return cache[p["bam"]]
    return get


def _port(p, env, *opts, device="cpu", **consts):
    """The port's call-methylation on corpus ``p`` under the switches
    ``env``, with 3 reads a pipeline chunk (PIPE_CHUNK) unless ``consts``
    sets the module's constants otherwise."""
    mp = pytest.MonkeyPatch()
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        for k, v in dict({"PIPE_CHUNK": 3}, **consts).items():
            mp.setattr(cm, k, v)
        out = io.StringIO()
        cm.main(_args(p) + list(opts) + ["--device", device], stdout=out)
        return out.getvalue()
    finally:
        mp.undo()


CORPORA = ["meth_pipeline", "straddle_pipe"]


@pytest.fixture(scope="module", autouse=True)
def jax_models_loaded():
    """The JAX PoreModelSet loads its built-in models on first use without
    a lock (nanopolish_tpu/models/pore_model.py:175-178): a first use from
    the JAX app's loader threads can see a half-filled registry, so it is
    made here, on one thread."""
    from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
    JaxModels.instance().get_model("r9.4_450bps", "nucleotide", "template", 6)


@pytest.mark.parametrize("corpus", CORPORA)
def test_object_path_matches_jax_object_path(corpus, request, monkeypatch):
    from nanopolish_tpu.apps import call_methylation as jax_app
    p = request.getfixturevalue(corpus)
    # the JAX app reads its chunk from NPT_METH_CHUNK; _port sets the
    # port's PIPE_CHUNK to the same 3 reads
    env = {"NPT_METH_ARRAY": "0", "NPT_METH_CHUNK": "3"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = io.StringIO()
    jax_app.main(_args(p), stdout=want)
    got = _port(p, {"NPT_METH_ARRAY": "0"})
    rep = assert_agree(got, want.getvalue(),
                       f"call-methylation NPT_METH_ARRAY=0 ({corpus})",
                       sign_cols=(LLR,))
    assert rep["flips"] == 0 and rep["rows"] > 10


@pytest.mark.parametrize("corpus, env, consts", [
    ("meth_pipeline", {"NPT_METH_ARRAY": "0"}, {}),
    ("straddle_pipe", {"NPT_METH_ARRAY": "0"}, {}),
    ("meth_pipeline", {"NPT_METH_NATIVE": "0"}, {}),
    ("straddle_pipe", {"NPT_METH_NATIVE": "0"}, {}),
    ("straddle_pipe", {}, {"LOADERS": 1})],
    ids=["meth_pipeline-ARRAY=0", "straddle_pipe-ARRAY=0",
         "meth_pipeline-NATIVE=0", "straddle_pipe-NATIVE=0",
         "straddle_pipe-LOADERS=1"])
def test_switches_print_the_array_paths_rows(corpus, env, consts, request,
                                             array_tsv):
    """Every route prints the default path's TSV byte for byte: the
    object path's indexed drain and the array path's flat Forward give
    the same scores, and the array path's NumPy geometry
    (NPT_METH_NATIVE=0) the native geometry's, as does one loader
    thread."""
    p = request.getfixturevalue(corpus)
    want = array_tsv(p)
    got = _port(p, env, **consts)
    assert got == want and len(got.splitlines()) > 10


@pytest.mark.parametrize("style", ["read", "reference"])
def test_object_path_modbam_equals_array_path(straddle_pipe, tmp_path,
                                              style):
    bams = {}
    for mode in ("1", "0"):
        bams[mode] = str(tmp_path / f"mods_{mode}.bam")
        _port(straddle_pipe, {"NPT_METH_ARRAY": mode},
              "--modbam-output-name", bams[mode], "--modbam-style", style)
    assert _render_bam(bams["0"]) == _render_bam(bams["1"])
    assert "Mm:Z:C+m?" in _render_bam(bams["0"])


def test_motif_groups_match_jax():
    from nanopolish_tpu.apps.call_methylation import motif_groups as jax_mg
    rng = np.random.default_rng(5)
    for _ in range(200):
        sites = np.cumsum(rng.integers(1, 25, rng.integers(0, 40))).tolist()
        sep = int(rng.integers(0, 15))
        assert cm.motif_groups(sites, sep) == jax_mg(sites, sep)
        gs, ge = cm._motif_group_spans(np.asarray(sites, np.int64), sep) \
            if sites else ([], [])
        assert list(zip(np.asarray(gs).tolist(), np.asarray(ge).tolist())) \
            == cm.motif_groups(sites, sep)


def _reads_and_refs(p, readdb, loader, fasta, bam_processor, **kw):
    from nanopolish_tpu_torch.utils.alphabet import DNA_ALPHABET
    read_db = readdb()
    read_db.load(p["fastq"])
    fai = fasta(p["ref_fa"])
    proc = bam_processor(p["bam"], batch_size=512, min_mapping_quality=20)
    batch = next(proc.batches())
    reads = loader(sorted({r.qname for _, r in batch}), read_db,
                   num_threads=2, **kw)
    out = []
    for _, rec in batch:
        ref_seq = DNA_ALPHABET.disambiguate(
            fai.fetch(proc.references[rec.tid], rec.pos,
                      rec.reference_end() + 1).upper())
        out.append((reads.get(rec.qname), rec, ref_seq))
    proc.close()
    return out


@pytest.mark.parametrize("corpus", CORPORA)
def test_collect_read_tasks_matches_jax(corpus, request):
    """Each window's sequence pair, event range, kmer ranks in both
    directions and meta, against the JAX collect_read_tasks on the JAX
    package's reads of the same files, across the four methylation
    alphabets and a region clip."""
    from nanopolish_tpu.apps import call_methylation as jcm
    from nanopolish_tpu.apps.bam_processor import \
        BamBatchProcessor as JaxProcessor
    from nanopolish_tpu.io.fasta import FastaIndex as JaxFasta
    from nanopolish_tpu.io.readdb import ReadDB as JaxReadDB
    from nanopolish_tpu.models.read_loader import \
        load_squiggle_reads as jax_load
    from nanopolish_tpu_torch.apps.bam_processor import BamBatchProcessor
    from nanopolish_tpu_torch.io.fasta import FastaIndex
    from nanopolish_tpu_torch.io.readdb import ReadDB
    from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads
    p = request.getfixturevalue(corpus)
    port = _reads_and_refs(p, ReadDB, load_squiggle_reads, FastaIndex,
                           BamBatchProcessor, device="cpu")
    jax = _reads_and_refs(p, JaxReadDB, jax_load, JaxFasta, JaxProcessor)
    n = 0
    for mtype in ("cpg", "gpc", "dam", "dcm"):
        for region in ((-1, -1), (150, 900)):
            params = cm.CallingParameters(methylation_type=mtype)
            jparams = jcm.CallingParameters(methylation_type=mtype)
            for (sr, rec, ref), (jsr, jrec, jref) in zip(port, jax):
                assert ref == jref and rec.qname == jrec.qname
                if sr is None:
                    assert jsr is None
                    continue
                segs, metas = cm.collect_read_tasks(sr, rec, ref, rec.pos,
                                                    params, *region)
                jsegs, jmetas = jcm.collect_read_tasks(
                    jsr, jrec, jref, jrec.pos, jparams, *region)
                assert metas == jmetas
                assert len(segs) == len(jsegs) == 2 * len(metas)
                for (hs, es), (jhs, jes) in zip(segs, jsegs):
                    assert (hs.seq, hs.rc_seq) == (jhs.seq, jhs.rc_seq)
                    assert (es.strand, es.rc, es.stride, es.event_start_idx,
                            es.event_stop_idx) == \
                        (jes.strand, jes.rc, jes.stride,
                         jes.event_start_idx, jes.event_stop_idx)
                    k = sr.get_model_k(es.strand)
                    for rc in (False, True):
                        np.testing.assert_array_equal(
                            hs.kmer_ranks(k, rc), jhs.kmer_ranks(k, rc))
                n += len(metas)
    assert n > 40


@pytest.mark.parametrize("mode", ["0", "1"])
def test_sync_counts(straddle_pipe, mode):
    """Both paths fetch through utils.syncstats, the same count in two
    identical runs: one ingest fetch and one score fetch a chunk."""
    snaps = []
    for _ in range(2):
        with SYNC_STATS.capture() as snap:
            _port(straddle_pipe, {"NPT_METH_ARRAY": mode})
        snaps.append(snap)
    assert snaps[0].sync_count == snaps[1].sync_count == 2
    assert snaps[0].bytes_fetched == snaps[1].bytes_fetched > 0


@pytest.mark.cuda
def test_gpu_object_path_equals_cpu_array_path(meth_pipeline, array_tsv):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the indexed Forward kernel)")
    got = _port(meth_pipeline, {"NPT_METH_ARRAY": "0"}, device="cuda")
    assert_agree(got, array_tsv(meth_pipeline), "object path on the card",
                 sign_cols=(LLR,))
