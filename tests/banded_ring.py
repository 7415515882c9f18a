"""Model of csrc/banded_fill.cu's handoff schedule between its warps.

A block runs one read with WARPS warps: the chain warp, PRODUCERS producer
warps and CONSUMERS consumer warps (the warps 4k other than the chain
leave after the set-up).  The producers fill an emission ring of EM_BUFS
chunks of LOOKAHEAD bands; the chain reads it and writes each band's
cells, up-move candidates and ll_k to a cell ring of CELL_BUFS chunks; the
consumers read a band and the band before it from that ring and write the
band's trace row.  The warps meet on named barriers: FULL and EMPTY per
emission buffer, CFULL and CEMPTY per cell buffer, DONE among the
consumers.

``run_block`` plays each warp's program in the kernel's order (every ring
access, barrier and row write) under a seeded random interleaving (each
warp drawn with a weight of its own, so that some seeds run the chain far
ahead of its producers or consumers and others far behind), with
``bar.sync`` / ``bar.arrive`` as PTX defines them (a barrier completes when
its count of threads has arrived, then starts over), and checks:

  * no warp waits forever (the run ends with every warp done);
  * every read finds the version it expects: the chain reads chunk c's
    emissions from the producers' chunk c, a consumer reads the band
    before its run of a chunk's bands and the run's bands as the chain
    wrote them;
  * no slot is written while a reader of its current version has not read
    it yet;
  * every band's trace row is written once: bands 0 and 1 by consumer 0,
    bands 2 .. D - 1 by a consumer from the chain's band, bands D ..
    n_bands - 1 (past the read) by the producers.

Returns the row writes and the count of steps.
"""

import random

# the kernel's constants (tests/test_torch_banded.py holds them to
# csrc/banded_fill.cu)
LOOKAHEAD = 14
SPAN = 128                   # emissions a band's slot holds
EM_BUFS = 2
CELL_BUFS = 3
WARPS = 8
CHAIN_WARP = 0
PRODUCERS = 3
CONSUMERS = 3
BAR_FULL, BAR_EMPTY, BAR_CFULL, BAR_CEMPTY, BAR_DONE = 1, 3, 5, 8, 11


def roles():
    """Each warp's role and index: the kernel's warp - 1 - warp / 4 for
    the warps other than the chain and the idle ones."""
    out = {}
    for w in range(WARPS):
        if w == CHAIN_WARP:
            out[w] = ("chain", 0)
        elif w % 4 == CHAIN_WARP % 4:
            out[w] = ("idle", 0)
        else:
            i = w - 1 - w // 4
            out[w] = ("producer", i) if i < PRODUCERS else \
                ("consumer", i - PRODUCERS)
    return out


def n_chunks_for(D):
    return -(-(D - 2) // LOOKAHEAD) if D > 2 else 0


def chain(D):
    nc = n_chunks_for(D)
    # band 1 as the band before chunk 0
    yield ("write", "cell", (CELL_BUFS - 1, LOOKAHEAD - 1), 1)
    for c in range(nc):
        buf, cb = c % EM_BUFS, c % CELL_BUFS
        yield ("sync", BAR_FULL + buf, 32 * (1 + PRODUCERS))
        if c >= 2:
            yield ("sync", BAR_CEMPTY + (c - 2) % CELL_BUFS,
                   32 * (1 + CONSUMERS))
        b0 = 2 + c * LOOKAHEAD
        for s in range(min(LOOKAHEAD, D - b0)):
            yield ("read", "em", (buf, s), c)
            yield ("write", "cell", (cb, s), b0 + s)
        if c + 2 < nc:
            yield ("arrive", BAR_EMPTY + buf, 32 * (1 + PRODUCERS))
        yield ("arrive", BAR_CFULL + cb, 32 * (1 + CONSUMERS))


def producer(D, n_bands, pw):
    nc = n_chunks_for(D)
    for c in range(nc):
        buf = c % EM_BUFS
        if c >= 2:
            yield ("sync", BAR_EMPTY + buf, 32 * (1 + PRODUCERS))
        b0 = 2 + c * LOOKAHEAD
        for s in range(pw, min(LOOKAHEAD, D - b0), PRODUCERS):
            yield ("write", "em", (buf, s), c)
        yield ("arrive", BAR_FULL + buf, 32 * (1 + PRODUCERS))
    for bi in range(D + pw, n_bands, PRODUCERS):
        yield ("row", bi, None)


def consumer(D, cw):
    nc = n_chunks_for(D)
    per = -(-LOOKAHEAD // CONSUMERS)
    if cw == 0:
        yield ("row", 0, None)
        yield ("row", 1, None)
    for c in range(nc):
        cb = c % CELL_BUFS
        pb = (c + CELL_BUFS - 1) % CELL_BUFS
        yield ("sync", BAR_CFULL + cb, 32 * (1 + CONSUMERS))
        b0 = 2 + c * LOOKAHEAD
        s0 = cw * per
        run = range(s0, min(s0 + per, LOOKAHEAD, D - b0))
        if len(run):
            # the band before the run once; then each band's cells carry
            yield ("read", "cell", (cb, s0 - 1) if s0 else (pb, LOOKAHEAD - 1),
                   b0 + s0 - 1)
        for s in run:
            yield ("read", "cell", (cb, s), b0 + s)
        for s in run:
            yield ("row", b0 + s, b0 + s)
        if c + 2 < nc:
            yield ("arrive", BAR_CEMPTY + cb, 32 * (1 + CONSUMERS))
    yield ("sync", BAR_DONE, 32 * CONSUMERS)


def readers(ring, version):
    """The reads a slot's version gets before it may be overwritten."""
    if ring == "em":
        return 1                                 # the chain
    return 1                                     # the consumer of its run


def run_block(D, n_bands, seed=0):
    """Play one block; raises AssertionError on a broken rule."""
    assert 2 <= D <= n_bands
    rng = random.Random(seed)
    weight = [rng.random() ** 3 + 1e-3 for _ in range(WARPS)]
    progs = {}
    for w, (role, i) in roles().items():
        if role == "chain":
            progs[w] = chain(D)
        elif role == "producer":
            progs[w] = producer(D, n_bands, i)
        elif role == "consumer":
            progs[w] = consumer(D, i)
    pending = {w: next(p, None) for w, p in progs.items()}
    waiting = {}                 # warp -> barrier id it waits on
    arrived = {}                 # barrier id -> threads arrived
    version, reads = {}, {}      # (ring, slot) -> band or chunk, reads
    rows = [0] * n_bands
    steps = 0
    live = [w for w in pending if pending[w] is not None]
    while live:
        runnable = [w for w in live if w not in waiting]
        assert runnable, f"deadlock: {waiting} at step {steps}"
        w = rng.choices(runnable, [weight[v] for v in runnable])[0]
        op, a, b = pending[w][:3]
        steps += 1
        if op in ("sync", "arrive"):
            n = arrived.get(a, 0) + 32
            assert n <= b, f"barrier {a} over its count"
            if n == b:
                arrived[a] = 0
                for v in [v for v, bar in waiting.items() if bar == a]:
                    del waiting[v]
            else:
                arrived[a] = n
                if op == "sync":
                    waiting[w] = a
        elif op == "write":
            key = (a, b)
            if key in version:
                assert reads[key] >= readers(a, version[key]), \
                    f"{key} overwritten before its readers were done"
            version[key], reads[key] = pending[w][3], 0
        elif op == "read":
            key = (a, b)
            assert version.get(key) == pending[w][3], \
                f"{key} holds {version.get(key)}, read as {pending[w][3]}"
            reads[key] += 1
        elif op == "row":
            rows[a] += 1
        # a warp waiting on a barrier has its next step ready for when the
        # barrier completes
        pending[w] = next(progs[w], None)
        if pending[w] is None:
            live.remove(w)
    assert not waiting and all(v == 0 for v in arrived.values())
    assert rows == [1] * n_bands, "a trace row written other than once"
    return rows, steps
