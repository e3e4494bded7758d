"""Library-design benchmark: BASELINE config #5 — a 100k-guide library
discovered and scored against a genome-scale database.

Thin standalone driver over bench.library_row (the official path — the
driver-run bench.py includes this row by default). Mirrors the reference
paper's heaviest sweep point (run_timing_collection.py: 100,000 guides x
maxMismatch=4 vs hg38; the checked-in replicate files stop at 1000 guides =
65 s, the 100k row exists only in the published paper).

Run: python tools/bench_library.py          (uses the bench.py database cache)
Env: BENCH_GENOME_MB (default: the bench cache's scale), LIB_GUIDES
     (default 100000).

Prints one JSON line with per-phase seconds.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import bench
    from flashfry_tpu.ops.scan import DeviceScanner, default_platform

    genome_mb = bench.resolve_genome_mb()
    db = bench.get_database(genome_mb)

    t0 = time.time()
    import jax.numpy as jnp
    np.asarray(jnp.zeros((), jnp.float32) + 1)
    platform = default_platform()
    bench.log("platform %s, init %.1fs" % (platform, time.time() - t0))

    t0 = time.time()
    scanner = DeviceScanner(db)
    bench.log("scanner init %.1fs" % (time.time() - t0))
    detail = {}
    bench.library_row(db, scanner, genome_mb, detail, platform)

    d = detail["library"]
    print(json.dumps({
        "metric": "library design: %dk guides discover+score, mm=4, %dMbp genome"
                  % (bench.LIB_GUIDES // 1000, genome_mb),
        "value": d["total_s"],
        "unit": "seconds (all phases)",
        "detail": d,
    }))


if __name__ == "__main__":
    main()
