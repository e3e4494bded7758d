"""Smoke test of the whole pipeline on an NVIDIA GPU, in one process.

    python chip_smoke.py                    # one card, human-scale genome
    python chip_smoke.py --genome-mb 20     # the same at a rehearsal size
    python chip_smoke.py --four-cards       # the 4-card discover path only

Phases (one card), each through the entry points a user calls
(flashfry_tpu.cli.main):

  1. device check: the first JAX device must be a GPU; prints its kind, the
     device count and the card's name and power limit (nvidia-smi);
  2. index: a synthetic genome (bench.synthesize_genome, fixed seed,
     repeat-rich) written as FASTA and indexed for spCas9-NGG;
  3. discover: 1000 guides sampled by genomic position, --backend jax
     --maxMismatch 4 --positionOutput. The scan's (target, guide, mm) hits
     must equal the numpy oracle on a 2M-target slice for all guides and on
     the whole database for 8 guides, and the exact host fallback must not
     have fired;
  4. score: five metrics with the device descriptor backend and with the
     numpy oracle; the two outputs must be byte-identical;
  5. stage-1 A/B over the resident database at guide blocks of 1024 and
     2048: the fused kernel against XLA's plain version (ops/scan.py
     stage1_plain), identical per-target hit flags, steady-state medians;
     the whole fused scan with each stage 1; the fused scan's memory
     analysis.

--four-cards runs only discover on 4 cards (ShardedScanner over the mesh)
and the same discover with a single-card DeviceScanner on device 0; the two
TSVs must be byte-identical.

Any failed check raises, so the process exits non-zero and prints no
result. The last line of standard output is one JSON object naming the
device. Scratch files live in .smoke_work/ inside the checkout and are
removed at the end; a summary is written to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
METRICS = "doench2014ontarget,doench2016cfd,dangerous,hsu2013,minot"
CONTIG_MB = 100          # the synthetic genome is written as 100 Mbp contigs
ORACLE_SLICE = 2_000_000
SEED = 2024


def log(msg):
    print(msg, flush=True)


def device_check(n_cards):
    """The card facts every number is printed beside; exits without one."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit("chip_smoke: JAX finds no GPU (platform %r)" % devs[0].platform)
    if len(devs) < n_cards:
        sys.exit("chip_smoke: need %d GPUs, JAX finds %d" % (n_cards, len(devs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("device: %s x%d (jax %s, numpy %s)" % (devs[0].device_kind, len(devs),
                                               jax.__version__, np.__version__))
    log("nvidia-smi: %s" % smi.stdout.strip().replace("\n", " | "))
    return devs, card


class Report:
    """Prints each phase result beside the card and collects a summary."""

    def __init__(self, card, genome_mb):
        self.card = card
        self.rows = {"card": card, "genome_mb": genome_mb}

    def __call__(self, key, value, note=""):
        self.rows[key] = value
        log("%-34s %s %s  [%s]" % (key, value, note, self.card))

    def save(self):
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "chip_smoke.json"), "w") as fh:
            json.dump(self.rows, fh, indent=1)


def timed(fn, *a):
    t0 = time.perf_counter()
    r = fn(*a)
    return r, time.perf_counter() - t0


def write_genome_fasta(path, genome_mb):
    from bench import synthesize_genome
    genome = synthesize_genome(genome_mb, np.random.default_rng(SEED))
    base_map = np.frombuffer(b"ACGT", dtype=np.uint8)
    step = CONTIG_MB * 1_000_000
    with open(path, "wb") as fh:
        for i, lo in enumerate(range(0, genome.shape[0], step)):
            fh.write(b">chr%d\n" % (i + 1))
            fh.write(base_map[genome[lo:lo + step]].tobytes())
            fh.write(b"\n")


def build_index(work, genome_mb, rep):
    from flashfry_tpu import cli
    from flashfry_tpu.database import load_database
    fa = os.path.join(work, "genome.fa")
    db_path = os.path.join(work, "genome.db")
    _, t = timed(write_genome_fasta, fa, genome_mb)
    rep("synthesize_write_fasta_s", round(t, 2))
    _, t = timed(cli.main, ["index", "--reference", fa, "--database", db_path,
                            "--enzyme", "spcas9ngg"])
    os.remove(fa)
    db = load_database(db_path)
    rep("index_s", round(t, 2), "(%d distinct targets)" % db.num_targets)
    rep("code_plane_gb", round(32 * db.num_targets / 1e9, 2))
    return db, db_path


def guide_fasta(db, n_guides, path, seed):
    from bench import sample_guides
    longs = sample_guides(db, n_guides, np.random.default_rng(seed))
    seqs, _ = db.bit_encoding().decode_batch(longs)
    with open(path, "w") as fh:
        fh.write("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))
    return longs


class FallbackCounter(logging.Handler):
    """Counts the scanners' "exact host fallback" warnings: a guide block
    that exhausted its cap retries and was scanned on the host."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        self.n += "exact host fallback" in record.getMessage()

    def __enter__(self):
        logging.getLogger("flashfry_tpu").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("flashfry_tpu").removeHandler(self)


class HitTee:
    """Records the (target, guide, mm) batches the scan hands to the hit
    collector, and the guide order they index, during one discover."""

    def __enter__(self):
        from flashfry_tpu import engine
        self.engine, self.orig = engine, engine._collect_hits
        self.batches, self.guides = [], None

        def tee(db, guides, hit_iter, stats=None):
            self.guides = np.array([g.long_encoding for g in guides], np.uint64)

            def it():
                for t, g, m in hit_iter:
                    self.batches.append((np.asarray(t, np.int64),
                                         np.asarray(g, np.int64),
                                         np.asarray(m, np.int64)))
                    yield t, g, m
            return self.orig(db, guides, it(), stats)

        engine._collect_hits = tee
        return self

    def __exit__(self, *exc):
        self.engine._collect_hits = self.orig

    def hits(self):
        t, g, m = (np.concatenate(x) for x in zip(*self.batches))
        return t, g, m


def check_against_oracle(db, tee, rep):
    from flashfry_tpu.bitcoding import STRING_MASK
    from flashfry_tpu.engine import brute_force_hits
    t_idx, g_idx, mm = tee.hits()
    guides = tee.guides & STRING_MASK
    enc = db.bit_encoding()
    n = db.num_targets
    lo = min(n // 2, max(0, n - ORACLE_SLICE))
    hi = min(n, lo + ORACLE_SLICE)
    t0 = time.perf_counter()
    mm_o = enc.mismatches_cross(guides, db.targets[lo:hi])        # (G, T)
    go, to = np.nonzero(mm_o <= 4)
    want = np.stack([to + lo, go, mm_o[go, to].astype(np.int64)])
    sel = (t_idx >= lo) & (t_idx < hi)
    got = np.stack([t_idx[sel], g_idx[sel], mm[sel]])
    got = got[:, np.lexsort(got[::-1])]
    want = want[:, np.lexsort(want[::-1])]
    if got.shape != want.shape or not (got == want).all():
        raise AssertionError("discover hits differ from the numpy oracle on "
                             "targets [%d, %d)" % (lo, hi))
    rep("oracle_slice_hits", int(want.shape[1]),
        "(all %d guides, targets [%d, %d), %.1f s)"
        % (guides.size, lo, hi, time.perf_counter() - t0))
    t0 = time.perf_counter()
    picks = np.linspace(0, guides.size - 1, 8).astype(int)
    total = 0
    for gi in picks:
        b_idx, b_mm = brute_force_hits(db, int(guides[gi]), 4)
        mine = g_idx == gi
        order = np.argsort(t_idx[mine], kind="stable")
        if not (np.array_equal(t_idx[mine][order], b_idx)
                and np.array_equal(mm[mine][order], b_mm.astype(np.int64))):
            raise AssertionError("guide %d: discover hits differ from a "
                                 "brute-force scan of the database" % gi)
        total += b_idx.size
    rep("brute_force_8_guides_hits", total,
        "(whole database, %.1f s)" % (time.perf_counter() - t0))


def discover_phase(db, db_path, work, n_guides, rep):
    from flashfry_tpu import cli
    gfa = os.path.join(work, "guides.fa")
    guide_fasta(db, n_guides, gfa, seed=7)
    out = os.path.join(work, "guides.out")
    with HitTee() as tee, FallbackCounter() as fallbacks:
        _, t = timed(cli.main, ["discover", "--fasta", gfa, "--database",
                                db_path, "--output", out, "--backend", "jax",
                                "--maxMismatch", "4", "--positionOutput"])
    rep("discover_s", round(t, 2), "(%d guides, mm=4, cold: includes "
        "compiles and the code-plane upload)" % tee.guides.size)
    rep("discover_hits", int(sum(b[0].size for b in tee.batches)))
    check_against_oracle(db, tee, rep)
    if fallbacks.n:
        raise AssertionError("the exact host fallback fired %d times"
                             % fallbacks.n)
    rep("host_fallbacks", 0)
    return out


def score_phase(db_path, out, work, rep):
    from flashfry_tpu import cli
    results = {}
    for backend in ("device", "numpy"):
        os.environ["FLASHFRY_TPU_SCORE_BACKEND"] = backend
        path = os.path.join(work, "guides.scored.%s" % backend)
        _, t = timed(cli.main, ["score", "--input", out, "--output", path,
                                "--scoringMetrics", METRICS,
                                "--database", db_path])
        rep("score_%s_s" % backend, round(t, 2))
        with open(path, "rb") as fh:
            results[backend] = fh.read()
    del os.environ["FLASHFRY_TPU_SCORE_BACKEND"]
    if results["device"] != results["numpy"]:
        raise AssertionError("device and numpy score outputs differ")
    rep("score_outputs_identical", True,
        "(%d bytes)" % len(results["numpy"]))


def steady(fn, *args, runs=5):
    """Median steady-state seconds: one warm-up, then `runs` timed calls,
    each ended by fetching a value from the result."""
    np.asarray(fn(*args)[:1])
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        np.asarray(fn(*args)[:1])
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def stage1_phase(db, rep):
    import jax
    import jax.numpy as jnp
    from bench import collect_hits, sample_guides
    from flashfry_tpu.ops import scan as S
    from flashfry_tpu.ops.scan_kernel import guide_block_layout, stage1_pallas

    pack = db.pack
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    thr = n_act - 4
    scanner = S.DeviceScanner(db)
    if not scanner.use_pallas or scanner.interpret:
        raise AssertionError("the GPU scanner is not on the compiled kernel")
    codes = scanner.codes
    n_cols = codes.shape[1]
    chunk = S.PLAIN_CHUNK
    guides = sample_guides(db, 2048, np.random.default_rng(11))

    def plain(fn):
        def all_chunks(codes, guide):
            flags = jax.lax.map(
                lambda c: fn(jax.lax.dynamic_slice_in_dim(
                    codes, c * chunk, chunk, axis=1), guide),
                jnp.arange(n_cols // chunk))
            return flags.reshape(-1)
        return jax.jit(all_chunks)

    plain_bf16 = plain(lambda c, g: S.stage1_plain(c, g, L, thr))
    for G in (1024, 2048):
        oh, _, _ = S.guide_onehot_matrix(guides[:G], pack, pad_to=G)
        goh = jax.device_put(oh)
        g_i8 = jax.jit(lambda g: guide_block_layout(g, L))(goh)
        g_bf = goh.astype(jnp.bfloat16)
        kern = jax.jit(stage1_pallas(n_act, 4, n_cols, G))
        flags = kern(codes, g_i8)
        if not bool(jnp.array_equal(flags, plain_bf16(codes, g_bf))):
            raise AssertionError("G=%d: kernel and XLA hit flags differ" % G)
        n_hit = int(flags.sum())
        del flags
        for name, fn, arg in (("kernel", kern, g_i8),
                              ("xla_bf16", plain_bf16, g_bf)):
            med, ts = steady(fn, codes, arg)
            rep("stage1_G%d_%s_s" % (G, name), round(med, 5),
                "(median of %s; %d columns, %d flagged)"
                % ([round(x, 5) for x in ts], n_cols, n_hit))
    # the fused scan's memory at G=1024, as the scanner compiles it
    oh, na, _ = S.guide_onehot_matrix(guides[:1000], pack, pad_to=1024)
    fused = S._fused_scan_jit(L, n_act, 4, scanner.chunk, 1024,
                              n_cols // scanner.chunk, S.DEFAULT_CAP,
                              S.TRIPLET_CAP, True, S.STAGE2_INT8,
                              S.TRIP_TILE, False)
    mem = fused.lower(codes, jax.device_put(oh),
                      jax.device_put(na)).compile().memory_analysis()
    log("fused scan memory_analysis (G=1024, chunk %d): %s"
        % (scanner.chunk, mem))
    # the whole fused scan, 1000 guides at mm=4, with each stage 1
    plain_scanner = S.DeviceScanner(db, use_pallas=False)
    scan_hits = {}
    for name, sc in (("kernel", scanner), ("xla_bf16", plain_scanner)):
        collect_hits(sc, guides[:1000], 4)           # compile + cap settle
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            t_idx, g_idx, mm = collect_hits(sc, guides[:1000], 4)
            ts.append(time.perf_counter() - t0)
        scan_hits[name] = (t_idx, g_idx, mm)
        rep("fused_scan_1000g_mm4_%s_s" % name, round(statistics.median(ts), 4),
            "(median of %s, chunk %d)" % ([round(x, 4) for x in ts], sc.chunk))
    a, b = scan_hits["kernel"], scan_hits["xla_bf16"]
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("fused scan hits differ between the stage 1s")


def four_cards_phase(db, db_path, work, n_guides, rep):
    import jax
    from flashfry_tpu import cli
    from flashfry_tpu.engine import discover
    from flashfry_tpu.discovery import find_target_sites
    from flashfry_tpu.ops.scan import DeviceScanner
    from flashfry_tpu.targetio import write_output
    from flashfry_tpu.utils import iterate_fasta
    gfa = os.path.join(work, "guides.fa")
    guide_fasta(db, n_guides, gfa, seed=7)
    out4 = os.path.join(work, "four.out")
    with FallbackCounter() as fallbacks:
        _, t = timed(cli.main, ["discover", "--fasta", gfa, "--database",
                                db_path, "--output", out4, "--backend", "jax",
                                "--maxMismatch", "4", "--positionOutput"])
    rep("discover_4_cards_s", round(t, 2), "(ShardedScanner, %d devices, cold)"
        % len(jax.devices()))
    out1 = os.path.join(work, "one.out")
    t0 = time.perf_counter()
    scanner = DeviceScanner(db)
    gsites = find_target_sites(iterate_fasta(gfa), db.pack,
                               flanking_sequence=6, capture_context=True)
    with fallbacks:
        guides = discover(db, gsites, max_mismatch=4, backend="jax",
                          scanner=scanner)
    write_output(out1, guides, db.bit_encoding(), db.bit_position(),
                 models=(), write_ots=True, write_positions=True)
    rep("discover_1_card_s", round(time.perf_counter() - t0, 2),
        "(DeviceScanner on %s, cold)" % scanner.codes.devices())
    with open(out4, "rb") as a, open(out1, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("4-card and 1-card discover TSVs differ")
    if fallbacks.n:
        raise AssertionError("the exact host fallback fired %d times"
                             % fallbacks.n)
    rep("four_card_tsv_identical", True, "(%d bytes)" % os.path.getsize(out1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=int, default=3000,
                    help="synthetic genome size in Mbp")
    ap.add_argument("--guides", type=int, default=1000)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card discover and its 1-card "
                         "comparison")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    genome_mb = args.genome_mb

    devs, card = device_check(n_cards)
    rep = Report(card, genome_mb)
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_all = time.perf_counter()
    try:
        db, db_path = build_index(work, genome_mb, rep)
        if args.four_cards:
            four_cards_phase(db, db_path, work, args.guides, rep)
        else:
            out = discover_phase(db, db_path, work, args.guides, rep)
            score_phase(db_path, out, work, rep)
            stage1_phase(db, rep)
        rep("total_s", round(time.perf_counter() - t_all, 1))
        rep.save()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
