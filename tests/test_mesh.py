"""Multi-chip sharded scan (virtual 8-device CPU mesh) must match the host
oracle and the single-device scanner exactly."""

import numpy as np
import pytest

from flashfry_tpu.bitcoding import BitEncoding
from flashfry_tpu.database import build_database_from_sites
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.engine import discover
from flashfry_tpu.parallel.mesh import ShardedScanner, make_mesh, sharded_scan_demo
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack


def _db(pack, n=120_000, seed=11):
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
    sites = find_target_sites(iter([("chrM", genome)]), pack)
    return build_database_from_sites(sites, 7), genome


def _cpu():
    """The virtual CPU devices the mesh tests run on (conftest sets 8)."""
    import jax
    return jax.devices("cpu")


def _oracle(db, guide_longs, max_mm):
    enc = BitEncoding(db.pack)
    mm = enc.mismatches_cross(db.targets, np.asarray(guide_longs, np.uint64))
    t, g = np.nonzero(mm <= max_mm)
    return sorted(zip(t.tolist(), g.tolist(), mm[t, g].astype(int).tolist()))


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack])
@pytest.mark.parametrize("n_devices", [4, 8])
def test_sharded_scanner_matches_oracle(pack, n_devices):
    db, _ = _db(pack)
    rng = np.random.default_rng(7)
    guides = db.targets[rng.choice(db.num_targets, size=20, replace=False)]
    mesh = make_mesh(n_devices, _cpu())
    scanner = ShardedScanner(db, mesh=mesh, use_pallas=False, chunk=1 << 12)
    got = sorted((int(t), int(g), int(m))
                 for ts, gs, ms in scanner.scan(guides, 4)
                 for t, g, m in zip(ts, gs, ms))
    assert got == _oracle(db, guides, 4)


def test_sharded_scanner_global_target_order_per_guide():
    """Hits for each guide must arrive in ascending global target order —
    the ordering the overflow-cap semantics depend on."""
    db, _ = _db(Cas9NGGParameterPack, seed=13)
    rng = np.random.default_rng(9)
    guides = db.targets[rng.choice(db.num_targets, size=8, replace=False)]
    scanner = ShardedScanner(db, mesh=make_mesh(8, _cpu()), use_pallas=False, chunk=1 << 12)
    seen = {}
    for ts, gs, ms in scanner.scan(guides, 4):
        for t, g in zip(ts.tolist(), gs.tolist()):
            seen.setdefault(g, []).append(t)
    for g, t_list in seen.items():
        assert t_list == sorted(t_list), "guide %d hits out of order" % g


def test_sharded_overflow_retry_exact():
    db, _ = _db(Cas9NGGParameterPack, seed=17)
    rng = np.random.default_rng(23)
    guides = db.targets[rng.choice(db.num_targets, size=16, replace=False)]
    tiny = ShardedScanner(db, mesh=make_mesh(8, _cpu()), use_pallas=False,
                          chunk=1 << 12, cap=2, trip_cap=4)
    got = sorted((int(t), int(g), int(m))
                 for ts, gs, ms in tiny.scan(guides, 4)
                 for t, g, m in zip(ts, gs, ms))
    assert got == _oracle(db, guides, 4)


def test_discover_sharded_backend_byte_equal():
    """discover(backend='jax') on the 8-CPU mesh (ShardedScanner path) must
    equal the numpy backend guide-for-guide."""
    db, genome = _db(Cas9NGGParameterPack, seed=29)
    gsites = find_target_sites(iter([("g", genome[5000:6200])]),
                               Cas9NGGParameterPack,
                               flanking_sequence=6, capture_context=True)
    if len(gsites) == 0:
        pytest.skip("no guides")
    a = discover(db, gsites, max_mismatch=4, backend="numpy")
    b = discover(db, gsites, max_mismatch=4, backend="jax")
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.bases == y.bases
        assert [ot.sequence for ot in x.off_targets] == [ot.sequence for ot in y.off_targets]
        assert [list(ot.coordinates) for ot in x.off_targets] == [list(ot.coordinates) for ot in y.off_targets]
        assert x.full == y.full


def test_demo_collective_step():
    hit_any, total = sharded_scan_demo(8, targets_per_device=256, guides_per_device=4,
                                    devices=_cpu())
    assert total >= 1


def test_sharded_step_compiled_once_across_guide_blocks(monkeypatch):
    """Two same-shape guide blocks must share ONE traced executable
    (the _step memo); only cap escalation may add entries."""
    db, _ = _db(Cas9NGGParameterPack, seed=31)
    rng = np.random.default_rng(3)
    scanner = ShardedScanner(db, mesh=make_mesh(8, _cpu()), use_pallas=False, chunk=1 << 12)
    builds = []
    orig = type(scanner)._step

    def counting_step(self, *key):
        if key not in self._step_cache:
            builds.append(key)
        return orig(self, *key)

    monkeypatch.setattr(type(scanner), "_step", counting_step)
    g1 = db.targets[rng.choice(db.num_targets, size=40, replace=False)]
    g2 = db.targets[rng.choice(db.num_targets, size=40, replace=False)]
    for block in (g1, g2):
        for _ in scanner.scan(block, 4):
            pass
    assert len(builds) == 1, "same-shape guide blocks must share one executable"


def test_sharded_scan_pipelines_guide_blocks():
    """Later guide blocks must DISPATCH before earlier blocks' results are
    fetched (the PIPELINE_DEPTH-deep pipeline that overlaps fetches with
    device work), and the pipelined output must equal the numpy oracle."""
    from flashfry_tpu.engine import ScanStats, _scan_numpy

    db, _ = _db(Cas9NGGParameterPack, seed=33)
    rng = np.random.default_rng(5)
    scanner = ShardedScanner(db, mesh=make_mesh(8, _cpu()), use_pallas=False,
                             chunk=1 << 12)
    # blocks grow up to 2048*Gx=4096 guides; 5000 guides -> 2 blocks
    n_g = 5000
    guides = db.targets[rng.choice(db.num_targets, size=n_g, replace=True)]
    scanner._events = []
    got = [(int(t), int(g), int(m))
           for ts, gs, ms in scanner.scan(guides, 4)
           for t, g, m in zip(ts, gs, ms)]

    ev = scanner._events
    dispatches = [b for kind, b in ev if kind == "dispatch"]
    assert len(dispatches) >= 2, "expected multiple guide blocks"
    first_fetch = ev.index(("fetch", dispatches[0]))
    n_before = sum(1 for kind, b in ev[:first_fetch] if kind == "dispatch")
    assert n_before >= 2, \
        "second guide block must be dispatched before the first fetch: %r" % ev

    want = [(int(t), int(g), int(m))
            for ts, gs, ms in _scan_numpy(db, guides, 4, ScanStats(), None)
            for t, g, m in zip(ts, gs, ms)]
    assert sorted(got) == sorted(want)
    # per-guide global target-major order (the overflow-cap contract)
    per_guide = {}
    for t, g, m in got:
        per_guide.setdefault(g, []).append(t)
    for g, ts in per_guide.items():
        assert ts == sorted(ts)


def test_device_counter_matches_numpy_pruned_semantics():
    """discover's logged all_comparisons must carry the reference's
    post-pruning semantics (Traverser.scala:66-74) on every backend."""
    from flashfry_tpu.discovery import find_target_sites
    from flashfry_tpu.engine import ScanStats, discover

    db, genome = _db(Cas9NGGParameterPack, seed=37)
    fa = [("q", genome[:20_000])]
    stats = {}
    for backend in ("numpy", "jax"):
        st = ScanStats()
        gs = find_target_sites(iter(fa), Cas9NGGParameterPack,
                               capture_context=True)
        discover(db, gs, max_mismatch=3, backend=backend, stats=st)
        stats[backend] = st
    assert stats["jax"].all_comparisons == stats["numpy"].all_comparisons
    assert stats["jax"].all_comparisons < stats["jax"].dense_comparisons


def test_sharded_two_phase_fetch_matches_whole_buffer():
    """Forcing the count-first sliced fetch must reproduce the whole-buffer
    fetch byte-for-byte on the virtual mesh."""
    import numpy as np
    from flashfry_tpu.discovery import find_target_sites
    from flashfry_tpu.database import build_database_from_sites
    from flashfry_tpu.parallel.mesh import ShardedScanner, make_mesh
    from flashfry_tpu.standards import Cas9NGGParameterPack

    rng = np.random.default_rng(91)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=50000))
    sites = find_target_sites(iter([("chrT", genome)]), Cas9NGGParameterPack)
    db = build_database_from_sites(sites, 7)
    gsites = find_target_sites(iter([("g", genome[900:1700])]),
                               Cas9NGGParameterPack)
    guides = np.asarray(gsites.sequences)

    def collect(**kw):
        sc = ShardedScanner(db, mesh=make_mesh(4, _cpu()), use_pallas=False,
                            chunk=1 << 12)
        for k, v in kw.items():
            setattr(sc, k, v)
        return [(t, g, m)
                for ti, gi, mi in sc.scan(guides, 4)
                for t, g, m in zip(ti.tolist(), gi.tolist(), mi.tolist())]

    whole = collect()
    sliced = collect(FETCH_SLICE_MIN=0)
    assert sliced == whole and len(whole) > 0


def test_sharded_scanner_kernel_interpret_matches_oracle():
    """The stage-1 kernel under shard_map (interpreted on the CPU mesh)
    yields the oracle hit set, as the compiled kernel does on GPU meshes."""
    db, _ = _db(Cas9NGGParameterPack, seed=19)
    rng = np.random.default_rng(2)
    guides = db.targets[rng.choice(db.num_targets, size=20, replace=False)]
    scanner = ShardedScanner(db, mesh=make_mesh(4, _cpu()), use_pallas=True,
                             chunk=1 << 12)
    assert scanner.interpret
    got = sorted((int(t), int(g), int(m))
                 for ts, gs, ms in scanner.scan(guides, 4)
                 for t, g, m in zip(ts, gs, ms))
    assert got == _oracle(db, guides, 4)


def test_mesh_devices_follow_the_default_platform():
    """pick_devices takes the default platform's devices (no preference
    for the CPU); make_mesh takes explicit devices and refuses too few."""
    import jax
    from flashfry_tpu.parallel.mesh import pick_devices
    from flashfry_tpu.ops.scan import default_platform
    devs = pick_devices()
    assert devs == jax.devices(default_platform())
    assert pick_devices(2) == devs[:2]
    with pytest.raises(ValueError):
        pick_devices(len(devs) + 1)
    mesh = make_mesh(4, _cpu())
    assert mesh.shape == {"db": 2, "guides": 2}
    assert list(mesh.devices.flat) == _cpu()[:4]
    with pytest.raises(ValueError):
        make_mesh(len(_cpu()) + 1, _cpu())


def test_resident_scanner_from_another_database_is_refused():
    """discover(scanner=...) with a scanner over a different database raises
    ValueError (an assert would vanish under python -O)."""
    db_a, genome = _db(Cas9NGGParameterPack, seed=41)
    db_b, _ = _db(Cas9NGGParameterPack, seed=43)
    gsites = find_target_sites(iter([("g", genome[:600])]),
                               Cas9NGGParameterPack)
    scanner = ShardedScanner(db_b, mesh=make_mesh(2, _cpu()),
                             use_pallas=False, chunk=1 << 12)
    with pytest.raises(ValueError, match="different database"):
        discover(db_a, gsites, max_mismatch=3, backend="jax", scanner=scanner)
