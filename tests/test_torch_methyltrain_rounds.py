"""methyltrain's round loop and its scoring in nanopolish_tpu_torch:
the read cache across rounds, and ``read_model_score`` against the JAX
package's on the scorereads corpus (tests/test_torch_scorereads_phase.py).
"""

import numpy as np
import torch

from nanopolish_tpu_torch.apps import methyltrain as mt
from nanopolish_tpu_torch.apps import scorereads as sc
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from tests.printed_output import assert_agree
from tests.test_torch_methyltrain import PERTURB, _args, _run, build_corpus
from tests.test_torch_scorereads_phase import phased_pipeline  # noqa: F401

torch.set_num_threads(2)


def test_round_cache_equals_fresh_ingest(tmp_path):
    """Ingest once and put the as-ingested scalings objects back each
    round (the round loop's read cache) gives the same round as loading
    every read anew: the per-read tables cached against the scalings
    objects stay sound after calibration replaced them."""
    from nanopolish_tpu_torch.io.fasta import FastaIndex
    from nanopolish_tpu_torch.io.readdb import ReadDB
    c = build_corpus(str(tmp_path), 4)
    PoreModelSet.reset()
    pms = PoreModelSet.instance()
    model = pms.initialize(c["fofn"])[0]
    opt = mt.make_parser().parse_args(_args(c, "-c"))
    read_db = ReadDB()
    read_db.load(c["fastq"])
    fai = FastaIndex(c["ref"])
    cache = {}
    mt.collect_round_events(opt, read_db, fai, model,
                            np.random.default_rng(1), True, 0, None, cache,
                            device="cpu")
    sr = cache["__reads__"]["r0"][0]
    assert sr.scalings[0] is not cache["__reads__"]["r0"][1][0]
    # the next round's model differs, as a trained one would
    moved = model.with_states(model.level_mean + 0.5 * c["is_m"],
                              model.level_stdv)
    pms.add_model(moved)
    runs = []
    for rc in (cache, None):
        s = mt.collect_round_events(opt, read_db, fai, moved,
                                    np.random.default_rng(2), True, 1, None,
                                    rc, device="cpu")
        runs.append([(x.num_matches, x.num_stays, x.events) for x in s])
    PoreModelSet.reset()
    assert runs[0] == runs[1]
    assert sum(len(e) for _, _, e in runs[0]) > 200


def test_read_model_score_matches_jax(phased_pipeline):  # noqa: F811
    """read_model_score against the JAX function on the same reads and
    alignments: each score within the Forward tolerance per event, and
    the methyltrain lines it prints under the printed-output rule; the
    batch of every read (methyltrain's) gives each read the same score."""
    from nanopolish_tpu.alignment.eventalign import \
        align_reads_to_ref as jax_align
    from nanopolish_tpu.apps.scorereads import \
        read_model_score as jax_score
    from nanopolish_tpu.io.bam import BamReader as JaxBam
    from nanopolish_tpu.io.fasta import FastaIndex as JaxFasta
    from nanopolish_tpu.io.readdb import ReadDB as JaxReadDB
    from nanopolish_tpu.models.read_loader import \
        load_squiggle_reads as jax_load
    from nanopolish_tpu_torch.alignment.eventalign import align_reads_to_ref
    from nanopolish_tpu_torch.io.bam import BamReader
    from nanopolish_tpu_torch.io.fasta import FastaIndex
    from nanopolish_tpu_torch.io.readdb import ReadDB
    from nanopolish_tpu_torch.models.read_loader import load_squiggle_reads

    p = phased_pipeline
    scores = {}
    for pkg, (RDB, FAI, BAM, load, align, score) in {
            "port": (ReadDB, FastaIndex, BamReader, load_squiggle_reads,
                     align_reads_to_ref, sc.read_model_score),
            "jax": (JaxReadDB, JaxFasta, JaxBam, jax_load, jax_align,
                    jax_score)}.items():
        kw = {"device": "cpu"} if pkg == "port" else {}
        db = RDB()
        db.load(p["fastq"])
        fai = FAI(p["ref_fa"])
        br = BAM(p["bam"])
        recs = list(br)
        reads = load(sorted({r.qname for r in recs}), db, **kw)
        jobs = [(reads[r.qname], r, 0, i) for i, r in enumerate(recs)]
        alns = align(jobs, fai, br.references, **kw)
        items = [(sr, 0, fai, "tig1", ao)
                 for (sr, _, _, _), ao in zip(jobs, alns)]
        scores[pkg] = [score(*it, **kw) for it in items]
        if pkg == "port":
            assert sc.read_model_scores(items, device="cpu") == scores[pkg]
    got, want = np.array(scores["port"]), np.array(scores["jax"])
    assert len(want) == 2 and np.isfinite(want).all()
    # Forward scores within 2e-3 nats a 500-event chunk, per event
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 / 500)
    assert_agree("".join(f"0 m {i} 0 Original {v}\n"
                         for i, v in enumerate(got)),
                 "".join(f"0 m {i} 0 Original {v}\n"
                         for i, v in enumerate(want)),
                 "read_model_score lines")


def test_methyltrain_recovers_m_kmer_means(tmp_path):
    """The recovery rule of tests/test_methyltrain_e2e.py on the port, on
    its corpus (30 forward reads of the 600-base genome, M-kmer means
    raised by 4 pA, 4 rounds, 15 events to train): over the M-kmers that
    trained, the mean error after training is under 0.6 x the
    perturbation."""
    c = build_corpus(str(tmp_path / "c"), 30, reverse_every=0)
    _, _, trained = _run(mt, PoreModelSet,
                         _args(c, "--rounds", "4", "--no-write-models",
                               "--device", "cpu", min_events=15),
                         str(tmp_path / "run"))
    rows = [ln.split("\t") for ln in
            open(tmp_path / "run" / "methyltrain.summary").read().splitlines()]
    assert rows[0][:3] == ["model_short_name", "kmer", "num_matches"]
    ranks = [c["true"].alphabet.kmer_rank(f[1], 6) for f in rows[1:]
             if f[6] == "1" and "M" in f[1]]
    assert len(ranks) >= 3, "no methylated kmers trained"
    err = np.abs(trained.level_mean[ranks] - c["true"].level_mean[ranks])
    print(f"recovery: {len(ranks)} M-kmers trained, mean error "
          f"{err.mean():.3f} pA after a {PERTURB} pA perturbation")
    assert err.mean() < 0.6 * PERTURB, (err.mean(), len(ranks))
