"""Multi-host (2-process) scan: jax.distributed over 2 x 4 virtual CPU
devices must reproduce the host oracle hit set, with each process loading
only its own database slab (per-host shard construction)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _build_fixture(tmp_path):
    from flashfry_tpu.bitcoding import BitEncoding
    from flashfry_tpu.database import build_database_from_sites, save_database
    from flashfry_tpu.discovery import find_target_sites
    from flashfry_tpu.standards import Cas9NGGParameterPack

    rng = np.random.default_rng(41)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, size=100_000))
    sites = find_target_sites(iter([("chrM", genome)]), Cas9NGGParameterPack)
    db = build_database_from_sites(sites, 7)
    db_path = str(tmp_path / "db.npz")
    save_database(db, db_path)
    guides = db.targets[rng.choice(db.num_targets, size=24, replace=False)]
    guides_path = str(tmp_path / "guides.npz")
    np.savez(guides_path, guides=guides)

    enc = BitEncoding(db.pack)
    mm = enc.mismatches_cross(db.targets, guides)
    t, g = np.nonzero(mm <= 4)
    oracle = sorted(zip(t.tolist(), g.tolist(), mm[t, g].astype(int).tolist()))
    return db_path, guides_path, oracle


@pytest.mark.parametrize("fetch_slice_min", [None, "0"])
def test_two_process_scan_matches_oracle(tmp_path, fetch_slice_min):
    """fetch_slice_min=0 forces the two-phase count-first fetch (header
    slice + bucketed body slice) across processes — certifying that the
    explicitly-sharded slices keep db-axis sharding under jax.distributed
    (round-3 advisor finding: this path was only exercised single-process)."""
    db_path, guides_path, oracle = _build_fixture(tmp_path)
    port = _free_port()
    out = str(tmp_path / "hits.npz")

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    if fetch_slice_min is not None:
        env["FLASHFRY_TPU_FETCH_SLICE_MIN"] = fetch_slice_min

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "flashfry_tpu.parallel.multihost",
             "--coordinator", "localhost:%d" % port,
             "--numProcesses", "2", "--processId", str(pid),
             "--database", db_path, "--guides", guides_path,
             "--output", out, "--maxMismatch", "4"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=560) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    hits = np.load(out)["hits"]
    got = sorted(map(tuple, hits.tolist()))
    assert got == oracle


def test_discover_cli_two_process_byte_identical(tmp_path):
    """The PRODUCT multi-host path: `discover --coordinator ...` run once
    per process must produce byte-identical output to a single-process
    discover (process 0 writes; the scan shards the database across the
    processes' devices and allgathers the triplet buffers)."""
    db_path, guides_path, _ = _build_fixture(tmp_path)
    guides = np.load(guides_path)["guides"]

    from flashfry_tpu.bitcoding import BitEncoding
    from flashfry_tpu.standards import Cas9NGGParameterPack
    enc = BitEncoding(Cas9NGGParameterPack)
    seqs = [enc.decode(np.uint64(g))[0] for g in guides]
    fasta = str(tmp_path / "guides.fasta")
    with open(fasta, "w") as fh:
        fh.write("".join(">g%d\n%s\n" % (i, s) for i, s in enumerate(seqs)))

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    # single-process reference output (numpy backend oracle)
    ref_out = str(tmp_path / "single.out")
    r = subprocess.run(
        [sys.executable, "-m", "flashfry_tpu", "discover",
         "--fasta", fasta, "--database", db_path, "--output", ref_out,
         "--positionOutput", "--backend", "numpy"],
        env=env, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-3000:]

    port = _free_port()
    mh_out = str(tmp_path / "multihost.out")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "flashfry_tpu", "discover",
             "--fasta", fasta, "--database", db_path, "--output", mh_out,
             "--positionOutput",
             "--coordinator", "localhost:%d" % port,
             "--numProcesses", "2", "--processId", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=560) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    with open(ref_out, "rb") as fh:
        want = fh.read()
    with open(mh_out, "rb") as fh:
        got = fh.read()
    assert got == want, "multi-host discover output diverges from single-process"
