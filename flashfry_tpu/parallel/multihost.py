"""Multi-host (multi-process) discover execution.

The reference is a single JVM (SURVEY.md §5.8); this module supplies the
missing scale-out axis, via ``jax.distributed``:

  * axis mapping — the **"db" mesh axis spans hosts**: each process builds
    and uploads ONLY its local slab of the plane-major code database, read
    lazily from the memmap'd on-disk database (no host ever materializes the
    full 12 GB hg38 array — the round-1 design device_put the whole thing on
    every host). The only cross-host ("DCN") traffic on this axis is the
    fixed-size triplet buffers, a few hundred KB per guide block. The
    **"guides" axis stays within a host** so the data-parallel one-hot
    blocks and the stage-1 matmuls stay on the host's own interconnect.
  * every process runs the same SPMD program (shard_map over the global
    mesh); XLA inserts the collectives;
  * per-process results are exchanged with one
    ``multihost_utils.process_allgather`` of the compact triplet buffers,
    after which every host holds the identical global hit set in the same
    global target-major order as the single-chip scan.

``run_worker`` is the per-process entry used by tests /
``python -m flashfry_tpu.parallel.multihost`` (one invocation per host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh import ShardedScanner


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """jax.distributed bring-up (idempotent)."""
    import jax
    if not jax.distributed.is_initialized():
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_global_mesh():
    """(db, guides) mesh over ALL processes' devices, db-axis process-major:
    process p owns db rows [p*local_db, (p+1)*local_db) — contiguous
    ascending target ranges per host, so concatenating shards in db order
    reproduces the global scan order."""
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    n = len(devs)
    n_local = len(jax.local_devices())
    g_ax = 2 if n_local % 2 == 0 and n_local >= 2 else 1
    db_ax = n // g_ax
    arr = np.array(devs).reshape(db_ax, g_ax)
    return Mesh(arr, ("db", "guides"))


class MultiHostScanner(ShardedScanner):
    """ShardedScanner over a multi-process mesh with per-host shard loading.

    Overrides the two host<->device touch points that differ from the
    single-process sharded path: global-array construction for guide blocks
    and result fetch (process_allgather of the local buffers). Code upload
    is INHERITED from ShardedScanner._put_codes — its slab-wise packed-word
    upload (8 B/target + on-device plane expansion) already builds every
    host array per addressable shard via make_array_from_callback, so each
    host reads and uploads only its own db slab (the round-4 override here
    regressed to a 32 B/target host-side plane build, VERDICT r4 #4).
    """

    def _make_global(self, arr: np.ndarray, spec):
        import jax
        from jax.sharding import NamedSharding
        sharding = NamedSharding(self.mesh, spec)
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    dcn_allgather_bytes = 0   # cumulative payload gathered across hosts
    dcn_allgather_calls = 0   # one per fetched slice (header / body)

    def _fetch(self, out) -> np.ndarray:
        """Allgather the (D, Gx, 2, width) buffers: each process contributes
        its local db rows; db-axis is process-major so a reshape restores
        global order. Accumulates DCN byte counters (the basis of the
        2-host scaling model in README.md — the ONLY cross-host traffic on
        the db axis is these compact triplet slices)."""
        from jax.experimental import multihost_utils
        import jax
        n_proc = jax.process_count()
        if n_proc == 1:
            return np.asarray(out)
        local_rows = sorted({s.index[0].start or 0 for s in out.addressable_shards})
        local = np.stack([
            self._rows_for(out, r) for r in local_rows])    # (D_local, Gx, 2, w)
        gathered = multihost_utils.process_allgather(local)  # (n_proc, D_local, ...)
        self.dcn_allgather_bytes += int(gathered.nbytes)
        self.dcn_allgather_calls += 1
        return gathered.reshape(self.D, self.Gx, *local.shape[2:])

    @staticmethod
    def _rows_for(out, row_start: int) -> np.ndarray:
        """Assemble db-row `row_start`'s (Gx, 2, width) block from the
        addressable shards."""
        parts = {}
        for s in out.addressable_shards:
            if (s.index[0].start or 0) == row_start:
                parts[s.index[1].start or 0] = np.asarray(s.data)[0]
        return np.concatenate([parts[k] for k in sorted(parts)], axis=0)


def run_worker(coordinator_address: str, num_processes: int, process_id: int,
               db_path: str, guides_path: str, out_path: Optional[str],
               max_mismatch: int = 4) -> np.ndarray:
    """One process of a multi-host scan: init, load the shared database
    (memmap — each host pages in only its slab), scan, return the global
    (target, guide, mm) hit rows (identical on every process). Process 0
    optionally writes them to ``out_path`` (.npz)."""
    initialize(coordinator_address, num_processes, process_id)
    from ..database import load_database
    db = load_database(db_path)
    guides = np.load(guides_path)["guides"].astype(np.uint64)
    mesh = make_global_mesh()
    scanner = MultiHostScanner(db, mesh=mesh, use_pallas=False)
    ts, gs, ms = [], [], []
    for t, g, m in scanner.scan(guides, max_mismatch):
        ts.append(np.asarray(t, dtype=np.int64))
        gs.append(np.asarray(g, dtype=np.int64))
        ms.append(np.asarray(m, dtype=np.int64))
    if ts:
        hits = np.column_stack([np.concatenate(ts), np.concatenate(gs),
                                np.concatenate(ms)])
    else:
        hits = np.zeros((0, 3), dtype=np.int64)
    import jax
    import logging
    logging.getLogger(__name__).info(
        "DCN allgather: %d bytes over %d calls (%d hit rows)",
        scanner.dcn_allgather_bytes, scanner.dcn_allgather_calls,
        hits.shape[0])
    if out_path and jax.process_index() == 0:
        np.savez(out_path, hits=hits)
    return hits


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="multi-host discover worker")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--numProcesses", type=int, required=True)
    ap.add_argument("--processId", type=int, required=True)
    ap.add_argument("--database", required=True)
    ap.add_argument("--guides", required=True, help=".npz with a 'guides' uint64 array")
    ap.add_argument("--output", default=None)
    ap.add_argument("--maxMismatch", type=int, default=4)
    a = ap.parse_args(argv)
    run_worker(a.coordinator, a.numProcesses, a.processId, a.database,
               a.guides, a.output, a.maxMismatch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
