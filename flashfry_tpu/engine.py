"""Off-target discovery engine.

Re-architecture of the reference's traversal machinery (reference:
modules/OffTargetDiscovery.scala:79-153, reference/traverser/*,
reference/binary/blocks/BlockManager.scala:212-254) for accelerator
execution:

  * the database is a flat device-resident array scanned in fixed-size
    chunks;
  * the guide×target mismatch count is computed for whole (guide-batch,
    chunk) tiles at once — on the device as one-hot matmuls
    (flashfry_tpu.ops.scan), on host as vectorized XOR+popcount numpy;
  * FlashFry's bin-traversal pruning (OrderedBinTraversalFactory.scala:146-173)
    becomes a (bins × guides) prefix-mismatch matrix computed in one shot;
    chunks whose bins prune away for every guide are skipped;
  * per-guide hit lists are reconstructed in global scan order, which equals
    FlashFry's traversal order, so OT output ordering and the overflow cap
    semantics (CRISPRSiteOT.scala:39-46: accept while current < cap, counting
    genomic positions) match exactly.

The hit SET produced equals brute force: FlashFry's bin pruning is lossless
(prefix mismatches lower-bound total mismatches), so a dense scan returns the
same hits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .bitcoding import BitEncoding, STRING_MASK
from .database import Database
from .discovery import DiscoveredSites
from .positions import BitPosition
from .targetio import GuideWithOffTargets
from .utils import gc_content


@dataclass
class ScanStats:
    """Counters mirroring the reference's Traverser counters
    (reference/traverser/Traverser.scala:66-74), plus phase timings for the
    discover epilogue (scan_seconds covers the whole scan+collect+counter
    span; collect/counter break out the host aggregation and the
    pruned-comparisons bookkeeping so a slow run is attributable)."""
    all_targets: int = 0
    all_targets_and_positions: int = 0  # targets weighted by genomic positions
    all_comparisons: int = 0          # FlashFry-equivalent comparisons (after pruning)
    dense_comparisons: int = 0        # raw guide x target comparisons performed
    scan_seconds: float = 0.0
    collect_seconds: float = 0.0      # _collect_hits (cap rule + CSR assembly)
    counter_seconds: float = 0.0      # pruned_comparisons_device bookkeeping


def bin_guide_mask(db: Database, guide_longs: np.ndarray, max_mismatch: int) -> np.ndarray:
    """(num_bins, G) bool — can bin b contain a <=max_mismatch hit for guide g?

    One-shot vectorized version of OrderedBinTraversalFactory's precompute
    (OrderedBinTraversalFactory.scala:146-173).
    """
    enc = db.bit_encoding()
    w = db.bin_width
    num_bins = db.num_bins
    # bin b's sequence as an integer occupies the same bit positions for all
    # bins: replicate binToLongComparitor vectorized.
    mask = enc.comp_bitmask_for_bin(w)
    p = db.pack
    if p.five_prime_pam:
        shift = np.uint64(2 * (p.total_scan_length - (w + p.pam_length)))
    else:
        shift = np.uint64(2 * (p.total_scan_length - w))
    bins = (np.arange(num_bins, dtype=np.uint64) << shift) & STRING_MASK
    g = np.asarray(guide_longs, dtype=np.uint64)
    mm = enc.mismatches_cross(bins, g & mask)
    return mm <= max_mismatch


def pruned_comparisons(db: Database, guide_longs: np.ndarray,
                       max_mismatch: int, guide_chunk: int = 4096) -> int:
    """FlashFry-equivalent comparison count: each guide is compared only
    against the targets of bins whose prefix is within max_mismatch of the
    guide's (Traverser.scala:66-74 counts post-pruning comparisons; the
    pruning predicate is OrderedBinTraversalFactory.scala:146-173 /
    LinearTraversal.scala:82-97 — both traversals prune). Equals the sum the
    masked numpy scan accumulates; computed here in O(bins x G) host time,
    chunked over guides so a 10^5-guide batch never materializes a
    (4^w x G) mask at once."""
    counts = db.bin_target_counts().astype(np.int64)
    g = np.asarray(guide_longs, dtype=np.uint64)
    total = 0
    for lo in range(0, g.shape[0], guide_chunk):
        m = bin_guide_mask(db, g[lo:lo + guide_chunk], max_mismatch)
        total += int(counts @ m.sum(axis=1, dtype=np.int64))
    return total


_jax_warmed = False


def _warm_jax_once() -> None:
    """Absorb the one-time jax/device init OUTSIDE any timed stat — on a
    cold CLI process the pruned counter is the first device op and would
    otherwise misreport init time as counter time. One fetch per PROCESS."""
    global _jax_warmed
    if _jax_warmed:
        return
    import jax.numpy as jnp
    np.asarray(jnp.zeros((), jnp.int32) + 1)
    _jax_warmed = True


def pruned_comparisons_device(db: Database, guide_longs: np.ndarray,
                              max_mismatch: int,
                              guide_chunk: int = 8192) -> int:
    """pruned_comparisons computed as (Gc, 4w) x (4w, 4^w) int8 matmuls on
    the default jax device — the same one-hot contraction as the scan's
    stage 1, so the O(bins x G) bookkeeping leaves the host. Exact:
    int32 accumulation throughout (per-guide sums < 2^31; the cross-guide
    sum is int64 on host). Every bin window lies inside the enzyme
    comparison mask for all six packs, so the per-digit compare equals
    bin_guide_mask's masked-long mismatch count (tests pin equality)."""
    import jax
    import jax.numpy as jnp
    # per-guide sums accumulate in device int32; fail loudly rather than
    # silently overflow the statistic on a >=2^31-target database (the host
    # pruned_comparisons path is int64 throughout and has no such limit)
    assert db.num_targets < 2 ** 31, \
        "pruned_comparisons_device: %d targets overflows int32 per-guide " \
        "sums; use pruned_comparisons (host) instead" % db.num_targets
    w = db.bin_width
    num_bins = db.num_bins
    counts = db.bin_target_counts().astype(np.int32)
    p = db.pack
    if p.five_prime_pam:
        shift = 2 * (p.total_scan_length - (w + p.pam_length))
    else:
        shift = 2 * (p.total_scan_length - w)
    digits = ((np.arange(num_bins, dtype=np.int64)[None, :]
               >> (2 * (w - 1 - np.arange(w))[:, None])) & 3)       # (w, B)
    bins_oh = (digits[:, None, :] ==
               np.arange(4)[None, :, None]).reshape(4 * w, num_bins)

    @jax.jit
    def chunk_sums(g_oh, b_oh, cnt):
        matches = jax.lax.dot(g_oh, b_oh,
                              preferred_element_type=jnp.int32)     # (Gc, B)
        ok = (w - matches <= max_mismatch).astype(jnp.int32)
        return jax.lax.dot(ok, cnt, preferred_element_type=jnp.int32)

    b_oh_d = jnp.asarray(bins_oh.astype(np.int8))
    cnt_d = jnp.asarray(counts)
    g = np.asarray(guide_longs, dtype=np.uint64)
    total = 0
    for lo in range(0, g.shape[0], guide_chunk):
        gc = g[lo:lo + guide_chunk]
        gd = ((gc[None, :] >> (np.uint64(shift)
                               + 2 * (w - 1 - np.arange(w, dtype=np.uint64))[:, None]))
              & np.uint64(3)).astype(np.int64)                      # (w, Gc)
        g_oh = (gd[:, None, :] ==
                np.arange(4)[None, :, None]).reshape(4 * w, -1).T   # (Gc, 4w)
        if g_oh.shape[0] < guide_chunk:
            g_oh = np.pad(g_oh, ((0, guide_chunk - g_oh.shape[0]), (0, 0)))
        per_guide = np.asarray(chunk_sums(
            jnp.asarray(g_oh.astype(np.int8)), b_oh_d, cnt_d))
        total += int(per_guide[:min(guide_chunk, g.shape[0] - lo)]
                     .astype(np.int64).sum())
    return total


def _scan_numpy(db: Database, guide_longs: np.ndarray, max_mismatch: int,
                stats: ScanStats, bin_mask: Optional[np.ndarray],
                chunk: int = 1 << 20):
    """Host scan: vectorized XOR+popcount over (G, chunk) tiles.

    Yields (target_idx int64[:], guide_idx int64[:], mm int8[:]) per chunk,
    target-major sorted (global scan order).
    """
    import logging
    logger = logging.getLogger("flashfry_tpu.engine")
    enc = db.bit_encoding()
    g = np.asarray(guide_longs, dtype=np.uint64)
    n = db.num_targets
    targets = db.targets
    tgt_bins = None
    if bin_mask is not None:
        # per-target bin index, to mask pruned (guide, target) pairs
        tgt_bins = np.repeat(np.arange(db.num_bins), db.bin_target_counts())
    t0 = time.time()
    for chunk_i, lo in enumerate(range(0, n, chunk)):
        hi = min(n, lo + chunk)
        if chunk_i and chunk_i % 64 == 0:
            # progress-line parity (SeekTraverser.scala:93-99)
            logger.info("Comparing the %sth chunk of %s targets; executed %s "
                        "comparisons so far (%.1fs)", format(chunk_i, ","),
                        format(hi - lo, ","), format(stats.all_comparisons, ","),
                        time.time() - t0)
        stats.all_targets_and_positions += int(db.pos_offsets[hi] - db.pos_offsets[lo])
        sub_mask = None
        if bin_mask is not None:
            sub_mask = bin_mask[tgt_bins[lo:hi]]  # (T, G)
            if not sub_mask.any():
                continue
        mm = enc.mismatches_cross(targets[lo:hi], g)  # (T, G): targets major
        stats.dense_comparisons += (hi - lo) * g.shape[0]
        hits = mm <= max_mismatch
        if sub_mask is not None:
            stats.all_comparisons += int(sub_mask.sum())
            hits &= sub_mask
        else:
            stats.all_comparisons += (hi - lo) * g.shape[0]
        stats.all_targets += hi - lo
        t_idx, g_idx = np.nonzero(hits)
        if t_idx.size:
            yield t_idx + lo, g_idx, mm[t_idx, g_idx].astype(np.int8)


def _collect_hits(db: Database, guides: List[GuideWithOffTargets],
                  hit_iter, stats: Optional[ScanStats] = None) -> None:
    """Apply hits to guides with the reference's overflow-cap rule: accept a
    hit iff current_total < cap before adding (ResultsAggregator.updateOT ->
    CRISPRSiteOT.addOT, crispr/CRISPRSiteOT.scala:41-46).

    Fully vectorized: hits arrive in global target order per guide (each
    guide lives in exactly one scan guide-block, and blocks stream their
    triplets target-major), so a stable sort by guide index groups each
    guide's hits in acceptance order; the cap is then an exclusive-cumsum
    threshold over per-hit position counts, and the accepted coordinate
    lists are one ragged gather from the database CSR arrays.
    """
    t_chunks, g_chunks = [], []
    for t_idx, g_idx, _mm in hit_iter:
        t_chunks.append(np.asarray(t_idx, dtype=np.int64))
        g_chunks.append(np.asarray(g_idx, dtype=np.int64))
    if not t_chunks:
        return
    t0 = time.time()  # post-scan host aggregation (the scan wait is above)
    t = np.concatenate(t_chunks)
    g = np.concatenate(g_chunks)
    n_guides = len(guides)

    # native one-pass collect: counting-scatter by guide + cap rule + CSR
    # assembly reading the (possibly memory-mapped) database arrays in
    # place — the numpy formulation below builds ~15 full-size temporaries
    # and two argsorts, which costs ~25 s at 18.7M hits on hosts with slow
    # first-touch page faults (the numpy path remains the oracle; tests
    # pin equality)
    from . import native as _native
    caps_arr = np.fromiter((gu.overflow_cap for gu in guides),
                           np.int64, n_guides)
    r = _native.collect_hits(t, g, db.pos_offsets, db.positions, db.targets,
                             caps_arr)
    if r is not None:
        hit_start, out_longs, coord_offsets, out_coords = r
        for gi in range(n_guides):
            s, e = int(hit_start[gi]), int(hit_start[gi + 1])
            if s == e:
                continue
            offs = coord_offsets[s:e + 1] - coord_offsets[s]
            guides[gi].set_ots_arrays(
                out_longs[s:e],
                out_coords[coord_offsets[s]:coord_offsets[e]], offs)
        if stats is not None:
            stats.collect_seconds += time.time() - t0
        return

    order = np.argsort(g, kind="stable")
    t = t[order]
    g = g[order]
    # Gather per-target offsets/positions through the UNIQUE sorted target
    # set: db.pos_offsets/db.positions are memory-mapped (3 GB each at hg38
    # scale) and random fancy-indexing pays a ~4 KB page fault per element;
    # ascending gathers ride readahead instead (~10 s -> <1 s at 145k hits).
    u, inv = np.unique(t, return_inverse=True)
    off_lo = np.asarray(db.pos_offsets[u], dtype=np.int64)
    off_hi = np.asarray(db.pos_offsets[u + 1], dtype=np.int64)
    lens_u = off_hi - off_lo

    # per-guide hit segments
    seg = np.searchsorted(g, np.arange(n_guides + 1, dtype=np.int64))
    pos_counts = lens_u[inv]
    cum = np.cumsum(pos_counts)
    excl = cum - pos_counts                       # positions before this hit
    seg_base = np.zeros(n_guides, dtype=np.int64)
    nonempty = seg[:-1] < seg[1:]
    seg_base[nonempty] = excl[seg[:-1][nonempty]]
    within_excl = excl - seg_base[g]              # guide-local exclusive cumsum

    caps = np.fromiter((gu.overflow_cap for gu in guides), np.int64, n_guides)
    accept = (caps[g] <= 0) | (within_excl < caps[g])
    t_acc = t[accept]
    g_acc = g[accept]

    # each unique target's position list, gathered ONCE in ascending order
    pool_off = np.zeros(u.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens_u, out=pool_off[1:])
    flat_u = (np.arange(int(pool_off[-1]), dtype=np.int64)
              - np.repeat(pool_off[:-1], lens_u)
              + np.repeat(off_lo, lens_u))
    pool = np.asarray(db.positions[flat_u])

    # ragged assembly of the accepted hits' lists from the in-RAM pool
    inv_acc = inv[accept]
    counts = pos_counts[accept]
    out_off = np.zeros(t_acc.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    total = int(out_off[-1])
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(out_off[:-1], counts)
            + np.repeat(pool_off[inv_acc], counts))
    coords = pool[flat]

    seg_a = np.searchsorted(g_acc, np.arange(n_guides + 1, dtype=np.int64))
    targets = db.targets
    for gi in range(n_guides):
        s, e = int(seg_a[gi]), int(seg_a[gi + 1])
        if s == e:
            continue
        offs = out_off[s:e + 1] - out_off[s]
        guides[gi].set_ots_arrays(targets[t_acc[s:e]],
                                  coords[out_off[s]:out_off[e]], offs)
    if stats is not None:
        stats.collect_seconds += time.time() - t0


def discover(db: Database, guide_sites: DiscoveredSites,
             max_mismatch: int = 4,
             maximum_off_targets: int = 2000,
             min_gc: float = 0.0, max_gc: float = 1.0,
             force_linear: bool = False,
             backend: str = "auto",
             stats: Optional[ScanStats] = None,
             scanner=None) -> List[GuideWithOffTargets]:
    """Run the discover phase; returns guides in output order.

    Mirrors OffTargetDiscovery.run (modules/OffTargetDiscovery.scala:79-153):
    GC filter, guide sort by start, scan, per-guide OT aggregation with the
    2000-position overflow cap, in traversal order.

    scanner: an existing DeviceScanner/ShardedScanner holding this database
    resident on device — repeat discover calls (score sweeps, benches) skip
    the multi-GB HBM upload. Ignored by the numpy backend.
    """
    if stats is None:
        stats = ScanStats()
    pack = db.pack
    enc = db.bit_encoding()

    bases = guide_sites.bases()
    contexts = guide_sites.contexts if guide_sites.contexts is not None else [None] * len(guide_sites)
    contig_names = [""] + guide_sites.contig_names

    rows = []
    for i in range(len(guide_sites)):
        gc = gc_content(bases[i])
        if gc < min_gc or gc > max_gc:
            continue
        rows.append(i)

    guides: List[GuideWithOffTargets] = []
    for i in rows:
        guides.append(GuideWithOffTargets(
            contig=contig_names[int(guide_sites.contig_ids[i])],
            start=int(guide_sites.positions[i]),
            bases=bases[i],
            forward_strand=bool(guide_sites.forward[i]),
            sequence_context=contexts[i],
            long_encoding=int(guide_sites.sequences[i] & STRING_MASK | (np.uint64(1) << np.uint64(48))),
            overflow_cap=maximum_off_targets,
        ))

    # ResultsAggregator presorts guides by start (CRISPRSiteOT.compare,
    # crispr/CRISPRSiteOT.scala:64); stable for ties
    guides.sort(key=lambda g: g.start)
    guide_longs = np.array([g.long_encoding for g in guides], dtype=np.uint64)

    if len(guides) == 0:
        return guides

    use_numpy = backend == "numpy" or (backend == "auto"
                                       and not _on_accelerator())
    bmask = None
    if not force_linear and use_numpy:
        # Traversal pruning only pays on the host scan; the device scan is
        # dense (bin pruning is lossless, so the hit set is identical) and
        # the (4^w x G) mask would cost O(bins*guides) memory at 10^5 guides.
        bmask = bin_guide_mask(db, guide_longs, max_mismatch)

    t0 = time.time()
    if not use_numpy and not force_linear:
        # Device scanners are dense (pruning is lossless, so the hit set is
        # identical) and track only dense_comparisons; the logged
        # all_comparisons must carry the reference's post-pruning semantics
        # (Traverser.scala:66-74, OffTargetDiscovery.scala:137). It is a
        # pure function of (db, guides, mm), computed BEFORE the scan: run
        # after collect, the same call intermittently cost ~11 s instead of
        # ~1.5 s at library scale (only with the multi-GB hit/TSV heap
        # resident — isolated runs are always fast), so do it on the lean
        # heap.
        if db.num_targets < 2 ** 31:
            _warm_jax_once()
        t_cnt = time.time()
        if db.num_targets < 2 ** 31:
            stats.all_comparisons = pruned_comparisons_device(
                db, guide_longs, max_mismatch)
        else:
            # beyond the device counter's int32 per-guide range (streaming
            # databases past hg38 scale): the int64 host counter, rather
            # than failing a finished discover over a log statistic
            stats.all_comparisons = pruned_comparisons(
                db, guide_longs, max_mismatch)
        stats.counter_seconds = time.time() - t_cnt
    if use_numpy:
        hit_iter = _scan_numpy(db, guide_longs, max_mismatch, stats, bmask)
    elif scanner is not None:
        # a resident scanner built from a DIFFERENT database would silently
        # scan the wrong genome; identity or a cheap content fingerprint
        # (ends + total position count — O(1) even on memmaps) must match
        sdb = scanner.db
        if not (sdb is db or (
                sdb.num_targets == db.num_targets
                and int(sdb.pos_offsets[-1]) == int(db.pos_offsets[-1])
                and (db.num_targets == 0
                     or (sdb.targets[0] == db.targets[0]
                         and sdb.targets[-1] == db.targets[-1])))):
            raise ValueError(
                "resident scanner was built from a different database")
        hit_iter = scanner.scan(guide_longs, max_mismatch, bmask, stats)
    elif _device_count() > 1:
        # multi-chip: database sharded over the mesh's "db" axis, guide batch
        # data-parallel over "guides" (flashfry_tpu/parallel/mesh.py)
        from .parallel.mesh import ShardedScanner
        hit_iter = ShardedScanner(db).scan(guide_longs, max_mismatch, bmask, stats)
    else:
        from .ops.scan import scan_database_jax
        hit_iter = scan_database_jax(db, guide_longs, max_mismatch, stats, bmask)
    _collect_hits(db, guides, hit_iter, stats)
    if not use_numpy and force_linear:
        # with --forceLinear the numpy path skips the bin mask; mirror
        # that (dense_comparisons is accumulated during the scan, so this
        # branch cannot move before it)
        stats.all_comparisons = stats.dense_comparisons
    stats.scan_seconds = time.time() - t0
    return guides


def _on_accelerator() -> bool:
    """Does jax place arrays on an accelerator? (--backend auto scans on
    the device then, and with the numpy oracle on a CPU-only runtime.) A
    broken accelerator runtime raises here rather than falling back."""
    from .ops.scan import default_platform
    return default_platform() != "cpu"


def _device_count() -> int:
    """Devices on the platform jax will actually place arrays on."""
    from .parallel.mesh import pick_devices
    return len(pick_devices())


def brute_force_hits(db: Database, guide_long: int, max_mismatch: int,
                     chunk: int = 1 << 24):
    """Oracle for tests: all (target_idx, mm) for one guide, scan order.
    Walks the database in chunks so a genome-scale scan needs no
    database-sized temporaries."""
    enc = db.bit_encoding()
    idx_parts, mm_parts = [], []
    for lo in range(0, db.num_targets, chunk):
        t = np.asarray(db.targets[lo:lo + chunk], dtype=np.uint64)
        mm = enc.mismatches(np.full(t.shape, guide_long, np.uint64), t)
        idx = np.nonzero(mm <= max_mismatch)[0]
        idx_parts.append(idx + lo)
        mm_parts.append(mm[idx])
    if not idx_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(idx_parts), np.concatenate(mm_parts)
