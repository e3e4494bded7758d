"""Multi-chip sharded off-target scan.

The reference is a single-threaded JVM program (SURVEY.md §2 checklist); this
module supplies the missing scaling axes:

  * "db" mesh axis     — the genome target database (plane-major codes, see
                         ops/scan.py) is sharded across chips along the
                         target axis (contiguous global-scan-order slabs,
                         resident in device memory);
  * "guides" mesh axis — the guide batch is data-parallel;
  * per-target hit flags are merged with a max-reduce over the guide axis,
    comparison counters with a psum over both axes — XLA collectives, not
    hand-rolled communication.

The mesh follows the algorithm alone: every card of a host reaches every
other at the same rate, so no device order is preferred.

Used by __graft_entry__.dryrun_multichip (virtual CPU mesh) and by the
multi-host discover path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pick_devices(n: Optional[int] = None):
    """The first n devices of the default platform (all of them when n is
    None). Callers that want another platform's devices (tests on a
    virtual CPU mesh) pass them to make_mesh."""
    import jax
    from ..ops.scan import default_platform
    devs = jax.devices(default_platform())
    if n is not None:
        if len(devs) < n:
            raise ValueError("need %d devices, have %d" % (n, len(devs)))
        devs = devs[:n]
    return devs


def make_mesh(n_devices: int, devices=None):
    """2D (db, guides) mesh over n_devices of `devices` (default:
    pick_devices); the guides axis gets a factor of 2 when possible."""
    from jax.sharding import Mesh
    devs = pick_devices(n_devices) if devices is None else list(devices)[:n_devices]
    if len(devs) < n_devices:
        raise ValueError("need %d devices, have %d" % (n_devices, len(devs)))
    g_ax = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    db_ax = n_devices // g_ax
    arr = np.array(devs).reshape(db_ax, g_ax)
    return Mesh(arr, ("db", "guides"))


def make_sharded_scan_step(mesh, L: int, max_mm: int):
    """Build the jitted multi-chip discover step.

    Inputs (global shapes):
      codes       (32, N) int8  plane-major target codes, sharded over "db"
      guide_oh    (G, 4L) f32   guide one-hot, sharded over "guides"
      n_active    (G,)  f32     per-guide active-base count (127 for padding)

    Returns:
      hit_any     (N,) bool     sharded over "db", replicated over "guides"
      total_hits  ()   int32    fully reduced comparison/hit counter
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops.scan import codes_onehot_jnp

    def local_step(codes, guide_oh, n_active):
        t_oh = codes_onehot_jnp(codes, L)                        # (4L, T_loc)
        matches = jax.lax.dot(guide_oh.astype(jnp.bfloat16), t_oh,
                              preferred_element_type=jnp.float32)  # (G_loc, T_loc)
        mm = n_active[:, None] - matches
        hit = mm <= max_mm
        hit_any_local = hit.any(axis=0)                          # (T_loc,)
        # merge over the guide (data-parallel) axis: logical OR == max
        hit_any = jax.lax.pmax(hit_any_local.astype(jnp.int32), "guides") > 0
        total = jax.lax.psum(jax.lax.psum(hit.sum().astype(jnp.int32), "guides"), "db")
        return hit_any, total

    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(None, "db"), P("guides", None), P("guides")),
        out_specs=(P("db"), P()),
        check_vma=False,
    )
    return jax.jit(step)


class ShardedScanner:
    """Multi-chip discover: the fused compaction scan, sharded over a
    (db, guides) mesh with shard_map.

    Each device owns a contiguous slab of the plane-major code database
    ("db" axis, model-parallel HBM sharding) and a sub-block of the guide
    batch ("guides" axis, data-parallel). Every device runs the same fused
    chunk loop as the single-chip DeviceScanner (ops/scan.py) over its
    (slab, guide sub-block) tile and compacts its hits into a fixed triplet
    buffer; the buffers are returned stacked (D, Gx, 2, width) and merged on
    host. Because db shards are ascending contiguous ranges and each shard's
    triplets are target-major, concatenating shards in order reproduces the
    global target-major order FlashFry applies hits in
    (reference/traverser/SeekTraverser.scala:58-104).

    Interface-compatible with DeviceScanner.scan; used when the runtime has
    more than one accelerator and by __graft_entry__.dryrun_multichip on a
    virtual CPU mesh.
    """

    def __init__(self, db, mesh=None, use_pallas: Optional[bool] = None,
                 chunk: Optional[int] = None, cap: int = 1 << 12,
                 trip_cap: int = 1 << 15):
        from ..ops.scan import (enable_compilation_cache, scan_chunk,
                                use_stage1_kernel)
        from ..ops.scan_kernel import T_TILE
        enable_compilation_cache()
        self.db = db
        self.L = db.pack.total_scan_length
        self.n_act = len(db.pack.comparison_mask_positions())
        if mesh is None:
            mesh = make_mesh(len(pick_devices()))
        self.mesh = mesh
        self.D = mesh.shape["db"]
        self.Gx = mesh.shape["guides"]
        platform = mesh.devices.flat[0].platform
        if use_pallas is None:
            use_pallas = use_stage1_kernel(platform)
        self.use_pallas = use_pallas
        self.interpret = use_pallas and platform == "cpu"  # tests only
        n = db.num_targets
        self.n = n
        per_shard = -(-max(n, 1) // self.D)
        if chunk is None:
            chunk = min(scan_chunk(use_pallas),
                        -(-per_shard // T_TILE) * T_TILE)
        chunk = scan_chunk(use_pallas, chunk)
        self.chunk = chunk
        self.cap = cap
        self.trip_cap = trip_cap
        # sticky escalated caps PER max_mismatch, threaded through each
        # scan as generator-locals (mirrors DeviceScanner: one mm=5 scan
        # must not leave later mm=4 scans paying 4x compaction domains,
        # and interleaved generators must not cross-contaminate)
        self._caps = {}
        import os
        fsm = os.environ.get("FLASHFRY_TPU_FETCH_SLICE_MIN")
        if fsm is not None:
            self.FETCH_SLICE_MIN = int(fsm)  # tests force the two-phase path
        self._step_cache = {}
        self._slice_cache = {}
        self.shard_n = -(-per_shard // chunk) * chunk   # targets per shard (padded)
        self.n_pad = self.shard_n * self.D
        self.codes = self._put_codes()

    def _put_codes(self):
        """Build + upload the sharded code planes: upload the packed 2-bit
        words (8 B/target, sharded over "db") SLAB BY SLAB and expand to
        plane-major codes on the devices with a shard_map — the sharded
        analog of ops.scan.device_plane_codes (4x less host->device traffic
        and no host-side 32-byte plane build; the expansion is pure
        elementwise shifts, so no collectives). Slabbing is mandatory, not
        an optimization: a whole-shard expand materializes (L, shard_n)
        int32 row temps before the int8 cast — 34 GB at hg38 scale, OOM —
        while per-slab temps stay under 1 GB and the donated buffer updates
        in place.

        Every host-side array is built through make_array_from_callback, so
        in a MULTI-PROCESS run each host touches only its ADDRESSABLE db
        shards: host p reads targets[p*shard_n : (p+1)*shard_n] from the
        memmap'd database and uploads 8 B/target of packed words — ~1.4 GB
        per host at hg38 scale (360M targets / 2 hosts), vs ~5.8 GB/host
        for the round-4 expanded-plane upload, with no host-side 32 B/target
        plane_codes build at all (VERDICT r4 #4)."""
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..ops.scan import CODE_ROWS, PAD_CODE, split_words

        n = self.db.num_targets
        L = self.L
        shard_n = self.shard_n
        slab = min(self.chunk, shard_n)
        assert shard_n % slab == 0, (shard_n, slab)
        D = self.D
        mesh = self.mesh
        sharding = NamedSharding(mesh, P(None, "db"))

        buf = jax.jit(
            lambda: jnp.full((CODE_ROWS, self.n_pad), PAD_CODE, jnp.int8),
            out_shardings=sharding)()

        def fill(buf_local, words_local, shard_idx, start, n_valid_global):
            w_lo, w_hi = words_local[0], words_local[1]       # (slab,)
            rows = []
            for i in range(L):
                s = 2 * (L - 1 - i)  # bases never straddle the 32-bit split
                w = w_lo if s < 32 else w_hi
                rows.append((jax.lax.shift_right_logical(w, s % 32) & 3)
                            .astype(jnp.int8))
            codes = jnp.stack(rows)                           # (L, slab) i8
            codes = jnp.pad(codes, ((0, CODE_ROWS - L), (0, 0)))
            base = shard_idx[0].astype(jnp.int32) * shard_n + start
            valid = base + jnp.arange(slab, dtype=jnp.int32) < n_valid_global
            codes = jnp.where(valid[None, :], codes, jnp.int8(PAD_CODE))
            return jax.lax.dynamic_update_slice(buf_local, codes, (0, start))

        step = shard_map(fill, mesh=mesh,
                         in_specs=(P(None, "db"), P(None, "db"), P("db"),
                                   None, None),
                         out_specs=P(None, "db"), check_vma=False)
        jitted = jax.jit(step, donate_argnums=(0,))
        shard_ids = jax.make_array_from_callback(
            (D,), NamedSharding(mesh, P("db")),
            lambda idx: np.arange(D, dtype=np.int32)[idx])

        targets = self.db.targets

        def words_for_slab(i):
            """Global (2, D*slab) packed-word array for slab i; the callback
            runs per ADDRESSABLE shard only, reading just that shard's
            target range from the (memmap-backed) database."""
            def build(idx):
                lo = idx[1].start or 0
                s = lo // slab                      # db-shard coordinate
                out = np.zeros((2, slab), dtype=np.int32)
                g_lo = s * shard_n + i * slab
                g_hi = min(max(g_lo, n), g_lo + slab)
                if g_hi > g_lo:
                    lo_h, hi_h = split_words(targets[g_lo:g_hi])
                    out[0, : g_hi - g_lo] = lo_h
                    out[1, : g_hi - g_lo] = hi_h
                return out
            return jax.make_array_from_callback((2, D * slab), sharding, build)

        for i in range(shard_n // slab):
            buf = jitted(buf, words_for_slab(i), shard_ids,
                         jnp.int32(i * slab), jnp.int32(n))
        return buf

    def _make_global(self, arr: np.ndarray, spec):
        """Host array -> global device array with the given PartitionSpec."""
        import jax
        from jax.sharding import NamedSharding
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def _fetch(self, out) -> np.ndarray:
        """Device (D, Gx, 2, width) triplet buffers -> host np array."""
        return np.asarray(out)

    def _step(self, max_mismatch: int, g_rows: int, col_cap: int, trip_cap: int):
        """Jitted multi-chip scan step, memoized per shape/cap tuple so
        repeat guide blocks reuse one traced executable (the single-device
        path memoizes the same way via ops.scan._fused_scan_jit)."""
        # STAGE2_INT8 / TRIP_TILE are process-constant config knobs: they
        # are snapshot at first build and deliberately NOT part of the key
        from ..ops import scan as _scan
        key = (max_mismatch, g_rows, col_cap, trip_cap)
        cached = self._step_cache.get(key)
        if cached is not None:
            return cached
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from ..ops.scan import make_fused_scan

        local = make_fused_scan(self.L, self.n_act, max_mismatch, self.chunk,
                                g_rows // self.Gx, self.shard_n // self.chunk,
                                col_cap, trip_cap, self.use_pallas,
                                _scan.STAGE2_INT8, _scan.TRIP_TILE,
                                self.interpret)

        def wrapped(codes_local, guide_oh_local, n_active_local):
            # this shard owns global targets [s*shard_n, (s+1)*shard_n);
            # padding columns hold PAD_CODE so no validity mask is needed
            buf = local(codes_local, guide_oh_local, n_active_local)
            return buf[None, None]

        step = shard_map(
            wrapped, mesh=self.mesh,
            in_specs=(P(None, "db"), P("guides", None), P("guides")),
            out_specs=P("db", "guides", None, None),
            check_vma=False,
        )
        jitted = jax.jit(step)
        self._step_cache[key] = jitted
        return jitted

    PIPELINE_DEPTH = 3  # in-flight sharded dispatches (mirrors DeviceScanner)

    def _record(self, kind: str, block: int) -> None:
        """Dispatch/fetch instrumentation: tests set self._events = [] and
        assert later blocks dispatch before earlier blocks fetch (i.e. the
        pipeline really keeps device work in flight across guide blocks)."""
        ev = getattr(self, "_events", None)
        if ev is not None:
            ev.append((kind, block))

    def scan(self, guide_longs: np.ndarray, max_mismatch: int,
             bin_mask=None, stats=None):
        """Yield (target_idx, guide_idx, mm) in global target-major order per
        guide (DeviceScanner.scan interface).

        Guide blocks are pipelined PIPELINE_DEPTH deep, exactly like the
        single-device path (ops/scan.py _scan_blocks): dispatch is async, so
        later blocks' sharded compute overlaps earlier blocks' device->host
        fetch. On cap overflow only the failed block retries; caps escalate
        stickily so later blocks dispatch straight at the size that worked."""
        from collections import deque

        from ..ops.scan import interleaved_blocks
        g_all = np.asarray(guide_longs, dtype=np.uint64)
        n_guides = g_all.shape[0]
        # same per-device max block as DeviceScanner (2048 measured faster
        # post-rework; see ops/scan.py block-size history)
        from ..ops.scan import max_guide_block
        max_block = max_guide_block()
        block = 128 * self.Gx
        while block < n_guides and block < max_block * self.Gx:
            block *= 2
        # round-robin dealing: sorted hot guide clusters (repeat families)
        # spread across blocks instead of exploding one block's caps
        blocks = interleaved_blocks(n_guides, block)
        pending = deque()
        it = iter(blocks)
        caps = list(self._caps.get(int(max_mismatch),
                                   (self.cap, self.trip_cap)))

        def fill():
            while len(pending) < self.PIPELINE_DEPTH:
                idx = next(it, None)
                if idx is None:
                    return
                self._record("dispatch", int(idx[0]) if idx.size else 0)
                out_d, used_col, trip_cap = self._dispatch(
                    g_all[idx], max_mismatch, stats, block, caps)
                pending.append((idx, out_d, used_col, trip_cap))

        try:
            fill()
            while pending:
                idx, out_d, used_col, trip_cap = pending.popleft()
                self._record("fetch", int(idx[0]) if idx.size else 0)
                for t_idx, g_idx, mm in self._collect_block(
                        g_all[idx], max_mismatch, block, out_d, used_col,
                        trip_cap, caps):
                    yield t_idx, idx[g_idx], mm
                fill()
        finally:
            self._caps[int(max_mismatch)] = (caps[0], caps[1])

    def _dispatch(self, guide_longs, max_mismatch, stats, pad_to, caps):
        """Launch one guide block asynchronously over the mesh; returns
        (global device buffer, trip_cap used)."""
        from jax.sharding import PartitionSpec as P
        from ..ops.scan import guide_onehot_matrix

        guide_oh, n_active, G = guide_onehot_matrix(guide_longs, self.db.pack,
                                                    pad_to=pad_to)
        if stats is not None and G:
            # all_comparisons (pruned-equivalent) is set by engine.discover
            stats.all_targets += self.n
            stats.all_targets_and_positions += int(self.db.pos_offsets[-1])
            stats.dense_comparisons += self.n * G
        goh_d = self._make_global(guide_oh, P("guides", None))
        na_d = self._make_global(n_active, P("guides"))
        step = self._step(max_mismatch, guide_oh.shape[0], caps[0], caps[1])
        return step(self.codes, goh_d, na_d), caps[0], caps[1]

    FETCH_SLICE_MIN = 1 << 19  # per-shard slots; larger buffers fetch count-first

    def _sliced(self, out_d, start: int, size: int, rows: int):
        """Slice axis 2 to [0, rows) and axis 3 to [start, start+size) with
        an EXPLICIT (db, guides) output sharding. Ad-hoc slicing of a
        sharded global array lets XLA's sharding propagation pick the result
        layout — if it replicated the tiny header slice,
        MultiHostScanner._fetch's addressable-shard indexing (which assumes
        db-axis sharding) would break in a true multi-process run. jit +
        out_shardings pins it. Jits are memoized per (start, size, rows,
        width): header + 64k-bucketed body slices form a bounded set."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        key = (start, size, rows, out_d.shape[3])
        fn = self._slice_cache.get(key)
        if fn is None:
            fn = jax.jit(
                lambda x: jax.lax.dynamic_slice_in_dim(
                    x, start, size, axis=3)[:, :, :rows],
                out_shardings=NamedSharding(
                    self.mesh, P("db", "guides", None, None)))
            self._slice_cache[key] = fn
        return fn(out_d)

    def _parse_buffers(self, out_d, trip_cap):
        """Fetch the (D, Gx, 2, width) sharded buffers -> per-shard parsed
        tuples [(t_idx, g_idx, mm, count, overflow)].

        Large buffers (escalated caps) fetch all D*Gx 2-word headers in ONE
        fetch, then ONE bucketed body slice sized to the largest per-shard
        triplet count — fetch cost scales with hits, not caps (the
        single-device analog is DeviceScanner._fetch_triplets; on multi-host
        each fetch is a process_allgather, so collapsing to two matters
        more, not less)."""
        import numpy as np
        from ..ops.scan import parse_trip_buffer
        width = out_d.shape[3]
        if width - 2 <= self.FETCH_SLICE_MIN:
            out = self._fetch(out_d)
            return [[parse_trip_buffer(out[s, q]) for q in range(self.Gx)]
                    for s in range(self.D)]
        heads = self._fetch(
            self._sliced(out_d, width - 2, 2, 1))            # (D, Gx, 1, 2)
        counts = heads[:, :, 0, 0].astype(np.int64)
        oflags = heads[:, :, 0, 1].astype(np.int64)
        bad = (oflags > 0) | (counts > trip_cap)
        n_max = int(np.where(bad, 0, counts).max(initial=0))
        z = np.zeros(0, np.int64)
        if n_max == 0:
            return [[(z, z, z.astype(np.int8), int(counts[s, q]),
                      int(oflags[s, q]))
                     for q in range(self.Gx)] for s in range(self.D)]
        bucket = min(width - 2, -(-n_max // (1 << 16)) * (1 << 16))
        body = self._fetch(self._sliced(out_d, 0, bucket, 2))
        parsed = []
        for s in range(self.D):
            row = []
            for q in range(self.Gx):
                n = 0 if bad[s, q] else int(counts[s, q])
                packed = body[s, q, 1, :n]
                row.append((body[s, q, 0, :n].astype(np.int64),
                            (packed >> 8).astype(np.int64),
                            (packed & 0xFF).astype(np.int8),
                            int(counts[s, q]), int(oflags[s, q])))
            parsed.append(row)
        return parsed

    def _collect_block(self, guide_longs, max_mismatch, pad_to, out_d,
                       used_col, trip_cap, caps):
        """Fetch + merge one guide block's sharded buffers; on cap overflow
        re-dispatch just this block at escalated caps. The caps==used
        guards prevent the pipeline's in-flight stale-cap failures from
        escalating several times in a burst (see DeviceScanner.escalate)."""
        from ..ops.scan import MAX_RETRIES

        g_local = pad_to // self.Gx
        for _attempt in range(1 + MAX_RETRIES):
            parsed = self._parse_buffers(out_d, trip_cap)
            col_of = any(p[4] & 1 for row in parsed for p in row)
            trip_of = any((p[4] & 2) or p[3] > trip_cap
                          for row in parsed for p in row)
            if not (col_of or trip_of):
                # merge: db shards in ascending order preserve global target
                # order; within a target, guide sub-blocks ascend
                for s in range(self.D):
                    base_t = s * self.shard_n
                    for q in range(self.Gx):
                        t_idx, g_idx, mm, count, _ = parsed[s][q]
                        if count:
                            yield (t_idx + base_t, g_idx + q * g_local, mm)
                return
            # sticky + selective escalation, HBM-bounded (see DeviceScanner:
            # col x2 for a finer stage-2 fit, trip x4)
            from ..ops.scan import COL_CAP_MAX, TRIP_CAP_MAX
            if col_of and caps[0] == used_col:
                caps[0] = min(caps[0] * 2, COL_CAP_MAX)
            if trip_of and caps[1] == trip_cap:
                caps[1] = min(caps[1] * 4, TRIP_CAP_MAX)
            if _attempt == MAX_RETRIES:
                break  # out of retries: exact host fallback below
            out_d, used_col, trip_cap = self._dispatch(
                guide_longs, max_mismatch, None, pad_to, caps)
        # exact host fallback (this guide block only)
        import logging
        logging.getLogger(__name__).warning(
            "sharded scan caps exhausted after %d retries; running the "
            "exact host fallback for one guide block (slow)", MAX_RETRIES)
        from ..bitcoding import BitEncoding
        enc = BitEncoding(self.db.pack)
        g = np.asarray(guide_longs, dtype=np.uint64)
        for lo in range(0, self.n, 1 << 20):
            hi = min(self.n, lo + (1 << 20))
            mm = enc.mismatches_cross(self.db.targets[lo:hi], g)
            t_idx, g_idx = np.nonzero(mm <= max_mismatch)
            if t_idx.size:
                yield t_idx + lo, g_idx, mm[t_idx, g_idx].astype(np.int8)


def sharded_scan_demo(n_devices: int, targets_per_device: int = 1024,
                      guides_per_device: int = 8,
                      devices=None) -> Tuple[np.ndarray, int]:
    """One full sharded step on synthetic data; returns (hit_any, total)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..bitcoding import BitEncoding
    from ..ops.scan import guide_onehot_matrix, plane_codes
    from ..standards import Cas9NGGParameterPack

    mesh = make_mesh(n_devices, devices)
    db_size = mesh.shape["db"]
    g_size = mesh.shape["guides"]
    pack = Cas9NGGParameterPack
    enc = BitEncoding(pack)
    L = pack.total_scan_length

    rng = np.random.default_rng(0)
    n = targets_per_device * db_size
    G = guides_per_device * g_size
    codes = rng.integers(0, 4, size=(n, L))
    seqs = ["".join("ACGT"[c] for c in row) for row in codes]
    target_longs = enc.encode_batch(seqs)
    guide_longs = target_longs[:G]  # guides drawn from targets: guaranteed hits

    code_planes = plane_codes(target_longs, L)
    guide_oh, n_active, _ = guide_onehot_matrix(guide_longs, pack, pad_to=G)
    guide_oh = guide_oh[:G]
    n_active = n_active[:G]

    step = make_sharded_scan_step(mesh, L, 4)
    codes_d = jax.device_put(code_planes, NamedSharding(mesh, P(None, "db")))
    goh_d = jax.device_put(guide_oh, NamedSharding(mesh, P("guides", None)))
    na_d = jax.device_put(n_active, NamedSharding(mesh, P("guides")))
    hit_any, total = step(codes_d, goh_d, na_d)
    return np.asarray(hit_any), int(total)
