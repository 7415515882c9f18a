"""nanopolish_tpu_torch `train-poremodel-from-basecalls --device cpu`
against the JAX package's app: the same basecalled reads give
byte-identical model files.  The per-kmer values feed np.median and
ndarray.std, whose sums depend on order, so the port keeps the JAX app's
order (reads, kmers ascending, events ascending).
"""

import os

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.apps import index as index_app
from nanopolish_tpu_torch.apps import train_poremodel_from_basecalls as tp
from nanopolish_tpu_torch.io.slow5 import Slow5Writer
from nanopolish_tpu_torch.models.pore_model import PoreModel, PoreModelSet
from nanopolish_tpu_torch.models.squiggle import SquiggleScalings
from nanopolish_tpu_torch.utils.alphabet import DNA_ALPHABET
from nanopolish_tpu_torch.utils.synthetic import (random_sequence,
                                                  synthetic_raw_signal)

torch.set_num_threads(2)


def basecalled_reads(d, n_reads, read_len, genome_len, seed, shift=1.5,
                     scale=1.01):
    """n_reads basecalls of read_len bases at random places and strands of
    a random genome, their signal drawn from the r9.4_450bps nucleotide
    model (scalings shift, scale), in a fastq + slow5 with its index."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    model = PoreModelSet.instance().get_model("r9.4_450bps", "nucleotide",
                                              "template", 6)
    genome = random_sequence(rng, genome_len)
    fastq, slow5 = os.path.join(d, "reads.fastq"), os.path.join(d, "s.slow5")
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for i in range(n_reads):
            pos = int(rng.integers(0, genome_len - read_len + 1))
            seq = genome[pos:pos + read_len]
            if rng.integers(0, 2):
                seq = DNA_ALPHABET.reverse_complement(seq)
            fq.write(f"@b{i}\n{seq}\n+\n{'I' * read_len}\n")
            pa = synthetic_raw_signal(
                rng, seq, model, SquiggleScalings.from4(shift, scale, 0.0,
                                                        1.0),
                samples_per_base=10.0, leader=400, trailer=100)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)
            sw.write(f"b{i}", adc, 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    return fastq, model


def level_error(model_path, truth: PoreModel):
    """(kmers updated from the bootstrap's 100 pA / 2.5 pA start, median
    |level_mean - truth's| over them)."""
    m = PoreModel.from_file(model_path)
    upd = m.level_stdv != 2.5
    return int(upd.sum()), float(np.median(np.abs(
        m.level_mean[upd] - truth.level_mean[upd])))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    # 8 reads of one 400-base stretch, so kmers collect >= 10 values
    return basecalled_reads(str(tmp_path_factory.mktemp("torch_tp")), 8,
                            400, 400, seed=61)


@pytest.mark.parametrize("rounds", [2])
def test_model_files_are_byte_identical(reads, tmp_path, rounds):
    from nanopolish_tpu.apps import train_poremodel_from_basecalls as jax_app
    fastq, truth = reads
    want, got = str(tmp_path / "jax.model"), str(tmp_path / "port.model")
    jax_app.main(["-r", fastq, "--rounds", str(rounds), "-o", want])
    tp.main(["-r", fastq, "--rounds", str(rounds), "-o", got, "--device",
             "cpu"])
    assert open(got, "rb").read() == open(want, "rb").read()
    n, err = level_error(got, truth)
    print(f"train-poremodel, {rounds} rounds: {n} kmers updated, median "
          f"|level - builtin| {err:.3f} pA")
    assert n >= 100


class _Events:
    """The event table's one column the app reads."""

    def __init__(self, mean):
        self.mean = mean

    def __len__(self):
        return len(self.mean)


def test_values_keep_the_order_of_the_per_event_loop():
    """_align_and_collect's per-kmer values equal the JAX app's double
    loop over reads, kmers and events, in order, including a failed read
    and a kmer with no events."""
    rng = np.random.default_rng(4)
    model = PoreModelSet.instance().get_model("r9.4_450bps", "nucleotide",
                                              "template", 6)
    reads = []
    for i in range(3):
        seq = random_sequence(rng, 60)
        ranks = DNA_ALPHABET.seq_to_kmer_ranks(seq, 6)
        n_ev = 2 * len(ranks)
        mean = model.level_mean[np.repeat(ranks, 2)] + rng.normal(0, 1, n_ev)
        if i == 1:
            mean = rng.uniform(40, 140, n_ev)       # garbage: fails QC
        reads.append((f"q{i}", seq, _Events(mean)))
    per_rank = tp._align_and_collect(reads, model, 6, device="cpu")
    from nanopolish_tpu_torch.ops.banded_exact import banded_align_exact
    want = [[] for _ in range(model.level_mean.shape[0])]
    T = max(len(et) for _, _, et in reads)
    K = max(len(s) - 5 for _, s, _ in reads)
    ev = np.zeros((3, T), np.float32)
    mu = np.zeros((3, K), np.float32)
    sd = np.ones((3, K), np.float32)
    nev = np.zeros(3, np.int32)
    nk = np.zeros(3, np.int32)
    rk = np.zeros((3, K), np.int64)
    for i, (_, seq, et) in enumerate(reads):
        ranks = DNA_ALPHABET.seq_to_kmer_ranks(seq, 6)
        ev[i, :len(et)] = et.mean
        mu[i, :len(ranks)] = model.level_mean[ranks]
        sd[i, :len(ranks)] = model.level_stdv[ranks]
        rk[i, :len(ranks)] = ranks
        nev[i], nk[i] = len(et), len(ranks)
    res = banded_align_exact(ev, nev, mu, sd, np.log(sd), nk, device="cpu")
    assert bool(res.failed[1]) and not bool(res.failed[0])
    for i in range(3):
        if bool(res.failed[i]):
            continue
        for ki in range(int(nk[i])):
            s, e = int(res.b2e_start[i, ki]), int(res.b2e_stop[i, ki])
            if s == -1:
                continue
            for ei in range(s, e + 1):
                if float(ev[i, ei]) >= 1.0:
                    want[int(rk[i, ki])].append(float(ev[i, ei]))
    assert [list(v) for v in per_rank] == want
    assert sum(map(len, want)) > 100


def test_kmer_size_option_matches_jax_app(reads, tmp_path):
    """-k 5 bootstraps a 5-mer model (1,024 kmers where the default has
    4,096), byte-identical to the JAX app's."""
    from nanopolish_tpu.apps import train_poremodel_from_basecalls as jax_app
    fastq, _ = reads
    want, got = str(tmp_path / "jax.model"), str(tmp_path / "port.model")
    jax_app.main(["-r", fastq, "-k", "5", "--rounds", "1", "-o", want])
    tp.main(["-r", fastq, "-k", "5", "--rounds", "1", "-o", got, "--device",
             "cpu"])
    assert open(got, "rb").read() == open(want, "rb").read()
    m = PoreModel.from_file(got)
    assert m.k == 5 and m.num_states == 4 ** 5
    assert int((m.level_stdv != 2.5).sum()) >= 50
