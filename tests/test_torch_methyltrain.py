"""nanopolish_tpu_torch `methyltrain --device cpu` against the JAX
package's app, on the corpus of tests/test_methyltrain_e2e.py:25-80 (its
600-base genome, rng 51, the cpg model with its M-kmer means raised by
4 pA) cut to 12 reads, every other one from the reverse strand, rebuilt
with the port's own writers.

What is held, and how:
  * the summary's integer columns (num_matches, num_skips, num_stays,
    num_events_for_training, was_trained) are identical, round by round;
  * the trained means and stdvs agree within the EM tolerance (the JAX
    EM is f32 with XLA's exp and log, the port's f64 rounded to f32);
  * the `--output-scores` lines (Forward scores) and the summary's printed
    means hold under the printed-output rule (tests/printed_output.py);
  * the over-cap reservoir draws the same rng stream: identical events.

From the second round on, the model being trained is the previous round's
EM output, so the two EMs' few-ulp difference, and the transition tables'
(tests/test_torch_scorereads_phase.py), reach the Viterbi alignment and
can turn a tie.  The 3-round case therefore gives the JAX app the port's
EM and transition table, and holds the JAX EM to the port's on each
round's inputs beside it (_port_em_in_jax).
"""

import io
import os

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.apps import methyltrain as mt
from nanopolish_tpu_torch.io.bam import BamRecord, BamWriter
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.utils.alphabet import (DNA_ALPHABET,
                                                 METHYL_CPG_ALPHABET)
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)
from tests.printed_output import assert_agree
from tests.test_torch_scorereads_phase import _port_transitions_in_jax
from nanopolish_tpu_torch.ops import mixture_em as em
from tests.test_torch_mixture_em import MEAN_ATOL

torch.set_num_threads(2)

GENOME_LEN = 600
N_READS = 12
PERTURB = 4.0
KEY = ("r9.4_450bps", "cpg", "template", 6)
INT_COLS = (2, 3, 4, 5, 6)      # num_matches .. was_trained
# 12 reads give each kmer of one strand ~6 events: train on 4
PARITY_MIN_EVENTS = 4
# trained stdvs of the apps' runs: kmers of 4-10 events whose two
# components split them evenly have a stdv of ~0.3 pA from a pair of
# events, where the EMs' few-ulp difference reached 2.2e-4 relative
# (tests/test_torch_mixture_em.py has the tolerance of well-filled kmers)
APP_STDV_RTOL = 1e-3


def build_corpus(d, n_reads, reverse_every=2):
    """The methylated genome as reference, n_reads 600-base reads of signal
    drawn from the true cpg model (every reverse_every-th from the reverse
    strand), and a fofn naming the perturbed start model."""
    os.makedirs(d, exist_ok=True)
    true_cpg = PoreModelSet.instance().get_model(*KEY)
    rng = np.random.default_rng(51)
    genome = ""
    while genome.count("CG") < 12:
        genome = random_sequence(rng, GENOME_LEN)
    meth_genome = METHYL_CPG_ALPHABET.methylate(genome)
    ref_fa = os.path.join(d, "ref_meth.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">tig1\n")
        for i in range(0, GENOME_LEN, 60):
            fh.write(meth_genome[i:i + 60] + "\n")
    is_m = np.array(["M" in true_cpg.alphabet.rank_to_kmer(r, 6)
                     for r in range(true_cpg.level_mean.shape[0])])
    pert_mean = true_cpg.level_mean.copy()
    pert_mean[is_m] += PERTURB
    model_path = os.path.join(d, "start.model")
    true_cpg.with_states(pert_mean, true_cpg.level_stdv.copy()).write(
        model_path, "r9.4_450bps.cpg.6mer.template.start")
    fofn = os.path.join(d, "models.fofn")
    with open(fofn, "w") as fh:
        fh.write(model_path + "\n")

    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "s.slow5")
    rev = [reverse_every and i % reverse_every == 1 for i in range(n_reads)]
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for i in range(n_reads):
            basecall = DNA_ALPHABET.reverse_complement(genome) if rev[i] \
                else genome
            fq.write(f"@r{i}\n{basecall}\n+\n{'I' * GENOME_LEN}\n")
            pa = synthetic_raw_signal(
                rng, METHYL_CPG_ALPHABET.methylate(basecall), true_cpg,
                SquiggleScalings.from4(0.0, 1.0, 0.0, 1.0),
                samples_per_base=10.0, leader=450, trailer=90)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)
            sw.write(f"r{i}", adc, 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = os.path.join(d, "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [GENOME_LEN])
    for i in range(n_reads):
        w.write(BamRecord(qname=f"r{i}", flag=16 if rev[i] else 0, tid=0,
                          pos=0, mapq=60, cigar=[(0, GENOME_LEN)], seq=genome,
                          qual=np.full(GENOME_LEN, 30, np.uint8)))
    w.close()
    return {"fastq": fastq, "bam": bam, "ref": ref_fa, "fofn": fofn,
            "is_m": is_m, "true": true_cpg}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("torch_mt")), N_READS)


def _args(c, *extra, min_events=PARITY_MIN_EVENTS):
    return ["-r", c["fastq"], "-b", c["bam"], "-g", c["ref"], "-m",
            c["fofn"], "--min-events", str(min_events), *extra]


def _run(app, pms_cls, argv, d):
    """Run one package's app in directory d; returns its stdout, the
    per-round integer columns of every kmer, and the final model."""
    os.makedirs(d, exist_ok=True)
    rounds = []
    real = app.retrain_model_from_events

    def spy(model, summaries, *a, **k):
        out = real(model, summaries, *a, **k)
        rounds.append(np.array([(s.num_matches, s.num_skips, s.num_stays,
                                 len(s.events)) for s in summaries]))
        return out

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.setattr(app, "retrain_model_from_events", spy)
        pms_cls.reset()
        try:
            app.main(argv, stdout=out)
            final = pms_cls.instance().get_model(*KEY)
        finally:
            pms_cls.reset()
    return out.getvalue(), rounds, final


RUNS = {1: (), 3: ("--output-scores", "-c")}


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both apps on the corpus: --rounds 1, and --rounds 3 with
    --output-scores -c, the JAX app given the port's EM
    (_port_em_in_jax).  {rounds: {"jax"|"port": (stdout, per-round
    integer columns, final model, run directory), "em_diffs": [...]}}"""
    from nanopolish_tpu.apps import methyltrain as jax_app
    from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
    out = {}
    for rounds, extra in RUNS.items():
        argv = _args(corpus, "--rounds", str(rounds), *extra)
        out[rounds] = {}
        em_diffs = []
        with pytest.MonkeyPatch.context() as mp:
            if rounds > 1:
                _port_em_in_jax(mp, em_diffs)
                _port_transitions_in_jax(mp)
            for pkg, app, models, more in (
                    ("jax", jax_app, JaxModels, []),
                    ("port", mt, PoreModelSet, ["--device", "cpu"])):
                d = str(tmp_path_factory.mktemp(f"mt_{pkg}_{rounds}"))
                out[rounds][pkg] = (*_run(app, models, argv + more, d), d)
        out[rounds]["em_diffs"] = em_diffs
    return out


def _port_em_in_jax(mp, diffs):
    """Give the JAX app the port's mixture EM, and record, for each
    round, how far the JAX package's own EM lands from it on the same
    inputs (max |d mean|, max relative d stdv of the trained component).

    Traced on this corpus: with its own EM and transition table, the JAX
    app's second round counts 1 of 15,625 kmers differently and its third
    155 (a turned Viterbi tie changes that read's recalibration, and so
    everything after it); with the port's EM alone, 1 and 220; with the
    port's EM and transition table, none."""
    import jax.numpy as jnp
    from nanopolish_tpu.apps import methyltrain as jax_app
    from nanopolish_tpu.ops.mixture_em import MixtureFit
    from nanopolish_tpu.ops.mixture_em import \
        train_gaussian_mixture_batched as jax_em

    def port_em(levels, svar, mask, logw0, mu0, sd0, n_iter=10):
        want = jax_em(levels, svar, mask, logw0, mu0, sd0, n_iter=n_iter)
        got = em.train_gaussian_mixture_batched(
            levels, svar, mask, logw0, mu0, sd0, n_iter=n_iter, device="cpu")
        wm = np.asarray(want.means)[:, 0]
        ws = np.asarray(want.stdvs)[:, 0]
        diffs.append((np.abs(got.means.numpy()[:, 0] - wm).max(),
                      (np.abs(got.stdvs.numpy()[:, 0] - ws) / ws).max()))
        return MixtureFit(*(jnp.asarray(t.numpy()) for t in got))

    mp.setattr(jax_app, "train_gaussian_mixture_packed", port_em)


def _model_columns(path):
    rows = [ln.split("\t") for ln in open(path).read().splitlines()
            if ln and not ln.startswith(("#", "kmer"))]
    return (np.array([float(r[1]) for r in rows]),
            np.array([float(r[2]) for r in rows]))


def _assert_models_agree(got_mean, got_stdv, want_mean, want_stdv, what):
    dm = np.abs(got_mean - want_mean)
    ds = np.abs(got_stdv - want_stdv) / want_stdv
    print(f"{what}: max |d mean| {dm.max():.3g} pA, max rel d stdv "
          f"{ds.max():.3g}, {int((dm > 0).sum())} means differ")
    assert dm.max() <= MEAN_ATOL, what
    assert ds.max() <= APP_STDV_RTOL, what


def _summary_agrees(got: str, want: str, what: str):
    gl = [ln.split("\t") for ln in got.splitlines()]
    wl = [ln.split("\t") for ln in want.splitlines()]
    assert len(gl) == len(wl) == 15_626
    for c in INT_COLS:
        assert [f[c] for f in gl] == [f[c] for f in wl], (what, c)
    assert_agree(got, want, what)


@pytest.mark.parametrize("rounds", sorted(RUNS))
def test_methyltrain_matches_jax_app(runs, corpus, capsys, rounds):
    """--rounds 1: everything of the JAX app's own run.  --rounds 3
    --output-scores -c: the JAX app with the port's EM, so the same model
    enters each round; the counts and models are then identical, and the
    JAX package's own EM, run beside it on each round's inputs, lands
    within the EM tolerance."""
    (want_out, want_rounds, want_model, jd), \
        (got_out, got_rounds, got_model, pd) = (runs[rounds]["jax"],
                                                runs[rounds]["port"])
    with capsys.disabled():
        assert len(got_rounds) == len(want_rounds) == rounds
        for r, (g, w) in enumerate(zip(got_rounds, want_rounds)):
            np.testing.assert_array_equal(g, w, err_msg=f"round {r}")
            name = f"r9.4_450bps.cpg.6mer.template.round{r}.model"
            _assert_models_agree(*_model_columns(os.path.join(pd, name)),
                                 *_model_columns(os.path.join(jd, name)),
                                 f"{rounds} rounds: round {r} model file")
        _assert_models_agree(got_model.level_mean, got_model.level_stdv,
                             want_model.level_mean, want_model.level_stdv,
                             f"{rounds} rounds: trained model")
        for r, (dm, ds) in enumerate(runs[rounds]["em_diffs"]):
            print(f"round {r}: the JAX EM on the port's inputs: max |d "
                  f"mean| {dm:.3g} pA, max rel d stdv {ds:.3g}")
            assert dm <= MEAN_ATOL and ds <= APP_STDV_RTOL
        assert len(runs[rounds]["em_diffs"]) == (rounds if rounds > 1 else 0)
        _summary_agrees(open(os.path.join(pd, "methyltrain.summary")).read(),
                        open(os.path.join(jd, "methyltrain.summary")).read(),
                        f"summary, {rounds} rounds")
        if RUNS[rounds]:
            rep = assert_agree(got_out, want_out, "--output-scores lines")
            kinds = [ln.split()[4] for ln in got_out.splitlines()]
            assert rep["rows"] == len(kinds) == 3 * rounds * N_READS
            assert {"Original", "Rescaled", "Delta"} == set(kinds)
        else:
            assert got_out == want_out == ""
    # methylated kmers train from the first round on
    assert (got_rounds[0][corpus["is_m"], 3] >= PARITY_MIN_EVENTS).sum() >= 20


def test_finalize_events_over_cap_matches_jax(monkeypatch):
    """Over the reservoir cap (MAX_EVENTS patched to 7 in both packages,
    as tests/test_methyltrain_e2e.py:235 does), the same NumPy rng gives
    the same reservoirs, across three batches that cross the cap."""
    from nanopolish_tpu.apps import methyltrain as jax_app
    monkeypatch.setattr(jax_app, "MAX_EVENTS", 7)
    monkeypatch.setattr(mt, "MAX_EVENTS", 7)
    rng = np.random.default_rng(3)
    R, n = 16, 600
    r_arr = rng.integers(0, R, n)
    l_arr = rng.normal(90, 10, n)
    sv_arr = np.round(rng.random(n), 3)
    st_arr = rng.choice(np.array([77, 69, 66], np.uint8), n)
    got, want = {}, {}
    for app, box in ((mt, got), (jax_app, want)):
        summaries = [app.KmerSummary() for _ in range(R)]
        counts = [np.zeros(R, np.int64) for _ in range(3)]
        draw = np.random.default_rng(11)
        for lo, hi in ((0, 70), (70, 301), (301, n)):
            acc = {"count_r": [r_arr[lo:hi]], "count_st": [st_arr[lo:hi]],
                   "r": [r_arr[lo:hi]], "l": [l_arr[lo:hi]],
                   "sv": [sv_arr[lo:hi]]}
            app._finalize_events(acc, summaries, *counts, draw)
        box["events"] = [s.events for s in summaries]
        box["counts"] = counts
        box["next"] = draw.integers(0, 1 << 30)
    assert got["events"] == want["events"]
    assert all(len(e) == 7 for e in got["events"])
    for g, w in zip(got["counts"], want["counts"]):
        np.testing.assert_array_equal(g, w)
    assert got["next"] == want["next"]


# methyltrain --seed: the reservoir cap the seed's case runs under
SEED_CAP = PARITY_MIN_EVENTS + 1


def _trained(summary: str, is_m):
    """(methylated, unmethylated) kmers the summary marks as trained."""
    rows = [ln.split("\t") for ln in summary.splitlines()[1:]]
    trained = np.array([r[6] == "1" for r in rows])
    return int((trained & is_m).sum()), int((trained & ~is_m).sum())


@pytest.mark.parametrize("case", ["train_kmers_all", "train_kmers_methylated",
                                  "train_kmers_unmethylated", "out_suffix",
                                  "seed_7"])
def test_methyltrain_options_match_jax_app(runs, corpus, tmp_path_factory,
                                           case):
    """--train-kmers (each value the parser takes), --out-suffix and --seed
    against the JAX app, one round, each shown to take effect: which
    kmers train, the names the summary and the model are written under,
    and (with the reservoir cap one event above --min-events in both
    packages, so that the kmers that train keep events the seed drew) the
    events the seed draws."""
    from nanopolish_tpu.apps import methyltrain as jax_app
    from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
    extra = {"train_kmers_all": ["--train-kmers", "all"],
             "train_kmers_methylated": ["--train-kmers", "methylated"],
             "train_kmers_unmethylated": ["--train-kmers", "unmethylated"],
             "out_suffix": ["--out-suffix", ".opt"],
             "seed_7": ["--seed", "7"]}[case]
    argv = _args(corpus, "--rounds", "1", *extra)
    suffix = extra[1] if case == "out_suffix" else ""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        if case == "seed_7":
            mp.setattr(jax_app, "MAX_EVENTS", SEED_CAP)
            mp.setattr(mt, "MAX_EVENTS", SEED_CAP)
        for pkg, app, models, more in (
                ("jax", jax_app, JaxModels, []),
                ("port", mt, PoreModelSet, ["--device", "cpu"])):
            d = str(tmp_path_factory.mktemp(f"mt_{case}_{pkg}"))
            out, rounds, final = _run(app, models, argv + more, d)
            got[pkg] = (rounds, d, final)
        if case == "seed_7":
            d = str(tmp_path_factory.mktemp(f"mt_{case}_default"))
            _, seed42, final42 = _run(mt, PoreModelSet, _args(
                corpus, "--rounds", "1", "--device", "cpu"), d)
    (g_rounds, pd, g_final), (w_rounds, jd, _) = got["port"], got["jax"]
    np.testing.assert_array_equal(g_rounds[0], w_rounds[0])
    name = f"r9.4_450bps.cpg.6mer.template{suffix}.round0.model"
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == sorted(
        [f"methyltrain{suffix}.summary", name])
    _assert_models_agree(*_model_columns(os.path.join(pd, name)),
                         *_model_columns(os.path.join(jd, name)),
                         f"methyltrain {' '.join(extra)}: round 0 model")
    summary = open(os.path.join(pd, f"methyltrain{suffix}.summary")).read()
    _summary_agrees(summary, open(os.path.join(
        jd, f"methyltrain{suffix}.summary")).read(),
        f"methyltrain {' '.join(extra)}: summary")
    n_m, n_u = _trained(summary, corpus["is_m"])
    default = runs[1]["port"]
    d_m, d_u = _trained(open(os.path.join(default[3], "methyltrain.summary"))
                        .read(), corpus["is_m"])
    assert d_m > 0 and d_u > 0
    if case == "train_kmers_methylated":
        assert (n_m, n_u) == (d_m, 0)
    elif case == "train_kmers_unmethylated":
        assert (n_m, n_u) == (0, d_u)
    elif case == "seed_7":
        # each kmer keeps at most SEED_CAP of its events, drawn by the
        # seed: the same counts as the port's seed-42 run under the same
        # cap, other events, so other trained means
        kept = g_rounds[0][:, 3]
        assert (kept <= SEED_CAP).all() and (kept == SEED_CAP).sum() >= 20
        np.testing.assert_array_equal(g_rounds[0], seed42[0])
        assert not np.array_equal(g_final.level_mean, final42.level_mean)
    else:
        assert (n_m, n_u) == (d_m, d_u)
