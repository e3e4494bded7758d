"""JAX scan backend must agree exactly with the numpy XOR+popcount oracle.

Every comparison here is exact equality: scan results are integers (int8
products accumulate in int32; bf16 products of 0/1 operands accumulate in
float32, exact for sums <= 24), so no tolerance applies at any matmul
precision setting.
"""

import numpy as np
import pytest

from flashfry_tpu.bitcoding import BitEncoding
from flashfry_tpu.database import build_database_from_sites
from flashfry_tpu.discovery import find_target_sites
from flashfry_tpu.engine import ScanStats, discover
from flashfry_tpu.ops.scan import DeviceScanner, guide_onehot_matrix, split_words
from flashfry_tpu.standards import Cas9NGGParameterPack, Cpf1ParameterPack


def random_genome(n, seed=0):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def build_db(seq, pack):
    sites = find_target_sites(iter([("chrT", seq)]), pack)
    return build_database_from_sites(sites, 7)


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack])
def test_device_scanner_matches_numpy(pack):
    genome = random_genome(60000, seed=21)
    db = build_db(genome, pack)
    enc = db.bit_encoding()

    gsrc = genome[2000:2600]
    gsites = find_target_sites(iter([("g", gsrc)]), pack)
    if len(gsites) == 0:
        pytest.skip("no guides")
    guide_longs = gsites.sequences

    scanner = DeviceScanner(db, use_pallas=False, chunk=1 << 14, cap=1 << 12)
    got = {}
    for t_idx, g_idx, mm in scanner.scan(np.asarray(guide_longs), 4):
        for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(g, []).append((t, m))

    expect_mm = enc.mismatches_cross(np.asarray(guide_longs, dtype=np.uint64), db.targets)
    for g in range(len(gsites)):
        t_hits = np.nonzero(expect_mm[g] <= 4)[0]
        expect = [(int(t), int(expect_mm[g, t])) for t in t_hits]
        assert got.get(g, []) == expect


def test_guide_onehot_matrix_semantics():
    pack = Cas9NGGParameterPack
    enc = BitEncoding(pack)
    guides = enc.encode_batch(["GAGTCCGAGCAGAAGAAGAAGGG", "A" * 23])
    oh, n_active, G = guide_onehot_matrix(guides, pack)
    assert G == 2
    assert oh.shape[0] % 128 == 0
    assert oh[0].sum() == 20  # 20 active guide bases
    assert n_active[0] == 20
    assert n_active[G] == 127  # padding rows can never hit
    # inner product of a guide with itself = n_active
    t_lo, t_hi = split_words(guides)
    codes = []
    L = pack.total_scan_length
    for i in range(L):
        s = 2 * (L - 1 - i)
        if s < 32:
            codes.append((t_lo[0] >> s) & 3)
        else:
            codes.append((t_hi[0] >> (s - 32)) & 3)
    t_oh = np.zeros(4 * L)
    for i, c in enumerate(codes):
        t_oh[4 * i + int(c)] = 1
    assert oh[0] @ t_oh == 20


def test_discover_jax_backend_equals_numpy_backend():
    genome = random_genome(50000, seed=22)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[1000:1400])]), Cas9NGGParameterPack,
                               flanking_sequence=6, capture_context=True)
    a = discover(db, gsites, max_mismatch=4, backend="numpy")
    b = discover(db, gsites, max_mismatch=4, backend="jax")
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.bases == y.bases
        assert [ot.sequence for ot in x.off_targets] == [ot.sequence for ot in y.off_targets]
        assert x.full == y.full


def test_stage2_cap_overflow_falls_back():
    # tiny cap forces the host fallback path; results must still be exact
    genome = random_genome(30000, seed=23)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[:2000])]), Cas9NGGParameterPack)
    if len(gsites) == 0:
        pytest.skip("no guides")
    guide_longs = np.asarray(gsites.sequences)
    enc = db.bit_encoding()

    small = DeviceScanner(db, use_pallas=False, chunk=1 << 13, cap=2)
    got = {}
    for t_idx, g_idx, mm in small.scan(guide_longs, 4):
        for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(g, []).append((t, m))
    expect_mm = enc.mismatches_cross(guide_longs, db.targets)
    for g in range(len(gsites)):
        t_hits = np.nonzero(expect_mm[g] <= 4)[0]
        assert sorted(got.get(g, [])) == [(int(t), int(expect_mm[g, t])) for t in t_hits]


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack])
def test_pallas_kernel_interpret_mode(pack):
    """The whole fused scan with the stage-1 kernel (interpreted on the CPU)
    must yield exactly the plain jnp stage 1's triplets, in order."""
    genome = random_genome(20000, seed=24)
    db = build_db(genome, pack)
    gsites = find_target_sites(iter([("g", genome[500:900])]), pack)
    assert len(gsites) > 0
    guide_longs = np.asarray(gsites.sequences)

    ref = DeviceScanner(db, use_pallas=False, chunk=1 << 13, cap=1 << 12)
    expect = [(t.tolist(), g.tolist(), m.tolist()) for t, g, m in ref.scan(guide_longs, 4)]
    pal = DeviceScanner(db, use_pallas=True, chunk=1 << 13, cap=1 << 12)
    assert pal.interpret and pal.use_pallas
    got = [(t.tolist(), g.tolist(), m.tolist()) for t, g, m in pal.scan(guide_longs, 4)]
    assert got == expect and len(expect) > 0


def _stage1_plain(codes, guide_oh, L, thr):
    """The plain stage 1 (make_fused_scan's CPU path) over all columns."""
    import jax.numpy as jnp

    from flashfry_tpu.ops.scan import stage1_plain
    return np.asarray(stage1_plain(jnp.asarray(codes),
                                   jnp.asarray(guide_oh, jnp.bfloat16), L, thr))


def _stage1_kernel(codes, guide_oh, pack, max_mm):
    import jax

    from flashfry_tpu.ops.scan_kernel import guide_block_layout, stage1_pallas
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    f = stage1_pallas(n_act, max_mm, codes.shape[1], guide_oh.shape[0],
                      interpret=True)
    return np.asarray(jax.jit(lambda c, g: f(c, guide_block_layout(g, L)))(
        codes, guide_oh))


@pytest.mark.parametrize("pack", [Cas9NGGParameterPack, Cpf1ParameterPack])
@pytest.mark.parametrize("n_guides", [1, 100, 130])
def test_stage1_kernel_matches_plain(pack, n_guides):
    """Per-target hit flags of the kernel equal the plain stage 1 for guide
    counts that are not a multiple of its guide tile (padding rows never
    fire), over one and two guide tiles."""
    from flashfry_tpu.ops.scan import guide_onehot_matrix, plane_codes
    from flashfry_tpu.ops.scan_kernel import G_TILE
    rng = np.random.default_rng(n_guides)
    L = pack.total_scan_length
    targets = rng.integers(0, 1 << (2 * L), size=3000, dtype=np.uint64)
    codes = plane_codes(targets, L, 4096)
    # guides near real targets, so some fire and some do not
    guides = targets[:n_guides] ^ rng.integers(0, 1 << 8, size=n_guides,
                                               dtype=np.uint64)
    oh, _, _ = guide_onehot_matrix(guides, pack, pad_to=G_TILE)
    n_act = len(pack.comparison_mask_positions())
    got = _stage1_kernel(codes, oh, pack, 4)
    want = _stage1_plain(codes, oh, L, n_act - 4)
    assert got.shape == (4096,)
    assert np.array_equal(got, want) and want[:3000].any()


def test_stage1_kernel_pad_columns_never_fire():
    """PAD_CODE columns (beyond the real targets) have an all-zero one-hot:
    even at the loosest threshold (1 match), where every real column fires,
    no padding column does."""
    from flashfry_tpu.ops.scan import (PAD_CODE, guide_onehot_matrix,
                                       plane_codes)
    pack = Cas9NGGParameterPack
    L = pack.total_scan_length
    rng = np.random.default_rng(5)
    targets = rng.integers(0, 1 << 46, size=1000, dtype=np.uint64)
    codes = plane_codes(targets, L, 2048)
    assert (codes[:, 1000:] == PAD_CODE).all()
    oh, _, _ = guide_onehot_matrix(targets[:64], pack)
    got = _stage1_kernel(codes, oh, pack, max_mm=99)   # threshold clamps to 1
    assert got[:1000].all() and not got[1000:].any()


@pytest.mark.parametrize("max_mm", [0, 3, 4])
def test_stage1_kernel_threshold_edge(max_mm):
    """A target exactly max_mm mismatches from a guide fires; one more
    mismatch does not."""
    from flashfry_tpu.ops.scan import guide_onehot_matrix, plane_codes
    pack = Cas9NGGParameterPack
    enc = BitEncoding(pack)
    L = pack.total_scan_length
    guide = "GAGTCCGAGCAGAAGAAGAAGGG"
    swap = {"A": "C", "C": "G", "G": "T", "T": "A"}

    def mutate(k):
        s = list(guide)
        for i in range(k):          # positions 0..k-1 are all active
            s[i] = swap[s[i]]
        return "".join(s)

    targets = enc.encode_batch([mutate(max_mm), mutate(max_mm + 1)])
    assert list(enc.mismatches(enc.encode_batch([guide])[0], targets)) == \
        [max_mm, max_mm + 1]
    codes = plane_codes(targets, L, 256)
    oh, _, _ = guide_onehot_matrix(enc.encode_batch([guide]), pack)
    got = _stage1_kernel(codes, oh, pack, max_mm)
    assert got[0] and not got[1:].any()


def test_scan_chunk_rounding():
    """The kernel path's chunk is a multiple of its T_TILE target tile
    (rounded down, at least one tile); the plain path keeps any chunk."""
    from flashfry_tpu.ops.scan import (DEFAULT_CHUNK, PLAIN_CHUNK,
                                       min_scan_chunk, scan_chunk)
    from flashfry_tpu.ops.scan_kernel import T_TILE
    assert scan_chunk(True) == DEFAULT_CHUNK and DEFAULT_CHUNK % T_TILE == 0
    assert scan_chunk(False) == PLAIN_CHUNK
    assert scan_chunk(True, 3 * T_TILE + 5) == 3 * T_TILE
    assert scan_chunk(True, T_TILE // 2) == T_TILE
    assert scan_chunk(False, 1000) == 1000
    assert min_scan_chunk(True) == T_TILE
    db = build_db(random_genome(20000, seed=9), Cas9NGGParameterPack)
    sc = DeviceScanner(db, use_pallas=True, chunk=5 * T_TILE + 1)
    assert sc.chunk == 5 * T_TILE and sc.codes.shape[1] % sc.chunk == 0


def test_stage1_choice_per_platform():
    """The GPU runs the kernel, the CPU the plain stage 1, and any other
    platform is refused rather than silently given the plain path."""
    from flashfry_tpu.ops.scan import use_stage1_kernel
    assert use_stage1_kernel("gpu") is True
    assert use_stage1_kernel("cpu") is False
    for other in ("rocm", "METAL", "interpreter"):
        with pytest.raises(ValueError):
            use_stage1_kernel(other)


@pytest.mark.gpu
def test_stage1_kernel_compiled_on_gpu(gpu_device):
    """The kernel as compiled for the card (no interpret mode) against the
    plain stage 1 on the same card, at a real guide-block width."""
    import jax

    from flashfry_tpu.ops.scan import guide_onehot_matrix, plane_codes
    from flashfry_tpu.ops.scan_kernel import guide_block_layout, stage1_pallas
    pack = Cas9NGGParameterPack
    L = pack.total_scan_length
    n_act = len(pack.comparison_mask_positions())
    rng = np.random.default_rng(1)
    targets = rng.integers(0, 1 << 46, size=1 << 20, dtype=np.uint64)
    guides = targets[rng.choice(targets.size, 1000, replace=False)]
    codes = jax.device_put(plane_codes(targets, L), gpu_device)
    oh, _, _ = guide_onehot_matrix(guides, pack, pad_to=1024)
    oh = jax.device_put(oh, gpu_device)
    f = stage1_pallas(n_act, 4, codes.shape[1], oh.shape[0])
    got = np.asarray(jax.jit(lambda c, g: f(c, guide_block_layout(g, L)))(
        codes, oh))
    assert np.array_equal(got, _stage1_plain(codes, oh, L, n_act - 4))


def test_memory_budget(monkeypatch):
    """The code budget is the device's reported limit less the working set;
    the CPU gets a fixed budget; an accelerator that reports no limit is an
    error; the environment variable overrides all."""
    from flashfry_tpu.ops import scan as S

    class FakeDevice:
        platform = "gpu"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    monkeypatch.delenv("FLASHFRY_TPU_HBM_BUDGET_GB", raising=False)
    assert S.hbm_budget_bytes(123) == S.CPU_CODE_BUDGET
    monkeypatch.setattr(S, "default_device",
                        lambda: FakeDevice({"bytes_limit": 60 << 30}))
    ws = S.scan_working_set_bytes(S.DEFAULT_CHUNK, True)
    assert S.hbm_budget_bytes(ws) == (60 << 30) - ws
    assert S.scan_working_set_bytes(S.PLAIN_CHUNK, False) > \
        S.scan_working_set_bytes(S.PLAIN_CHUNK, True)
    monkeypatch.setattr(S, "default_device", lambda: FakeDevice(None))
    with pytest.raises(RuntimeError):
        S.hbm_budget_bytes(ws)
    monkeypatch.setenv("FLASHFRY_TPU_HBM_BUDGET_GB", "2")
    assert S.hbm_budget_bytes(ws) == 2 << 30


def test_compile_cache_location(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache: nothing is
    set in code. Otherwise the cache is a fixed path inside the checkout."""
    import os

    import jax

    from flashfry_tpu.ops import scan as S
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("FLASHFRY_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(S, "_cache_enabled", False)
    S.enable_compilation_cache()
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setattr(S, "_cache_enabled", False)
    S.enable_compilation_cache()
    assert calls == [("jax_compilation_cache_dir", S.COMPILE_CACHE_DIR)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(S.COMPILE_CACHE_DIR) == root


def test_host_fallback_is_logged(monkeypatch, caplog):
    """A scan that exhausts its cap retries runs the exact host scan and
    says so in a warning (chip_smoke.py counts these and requires 0)."""
    import logging

    from flashfry_tpu.ops import scan as S
    genome = random_genome(30000, seed=23)
    db = build_db(genome, Cas9NGGParameterPack)
    guides = np.asarray(find_target_sites(iter([("g", genome[:2000])]),
                                          Cas9NGGParameterPack).sequences)
    monkeypatch.setattr(S, "MAX_RETRIES", 0)
    sc = DeviceScanner(db, use_pallas=False, chunk=1 << 13, cap=2)
    with caplog.at_level(logging.WARNING, logger="flashfry_tpu"):
        n = sum(len(t) for t, _, _ in sc.scan(guides, 4))
    assert n > 0
    assert sum("exact host fallback" in r.getMessage()
               for r in caplog.records) == 1


def test_fused_overflow_falls_back_to_chunked():
    """A tiny triplet cap forces the per-chunk fallback; hits must match."""
    genome = random_genome(30000, seed=5)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[1000:1800])]), Cas9NGGParameterPack)
    guide_longs = np.asarray(gsites.sequences)
    normal = DeviceScanner(db, use_pallas=False, chunk=1 << 10)
    tiny = DeviceScanner(db, use_pallas=False, chunk=1 << 10, trip_cap=8)
    got_a = [(int(t), int(g), int(m))
             for ts, gs, ms in normal.scan(guide_longs, 4)
             for t, g, m in zip(ts, gs, ms)]
    got_b = [(int(t), int(g), int(m))
             for ts, gs, ms in tiny.scan(guide_longs, 4)
             for t, g, m in zip(ts, gs, ms)]
    assert sorted(got_a) == sorted(got_b)
    assert len(got_a) > 8  # the cap really was exceeded


def test_packed_nonzero_matches_nonzero():
    """Two-level compaction (ops/scan._packed_nonzero) must agree exactly
    with np.nonzero across densities, sizes and both code paths (tiled and
    the small-array flat fallback)."""
    import jax
    import jax.numpy as jnp

    from flashfry_tpu.ops.scan import _packed_nonzero

    rng = np.random.default_rng(11)
    cases = []
    for n_el in (256, 512, 4096, 1 << 15, 1 << 17):
        for density in (0, 1, 3, n_el // 100 + 2, n_el):
            cases.append((n_el, min(density, n_el)))
    for n_el, n_hits in cases:
        mask = np.zeros(n_el, dtype=bool)
        hits = np.sort(rng.choice(n_el, size=n_hits, replace=False))
        mask[hits] = True
        for size in (16, 4096):
            idx, n = jax.jit(lambda m: _packed_nonzero(m, size))(jnp.asarray(mask))
            idx, n = np.asarray(idx), int(n)
            assert n == n_hits, (n_el, n_hits, size)
            k = min(n, size)
            assert np.array_equal(idx[:k], hits[:k]), (n_el, n_hits, size)


def test_packed_nonzero_clamps_overflow_indices():
    import jax.numpy as jnp

    from flashfry_tpu.ops.scan import _packed_nonzero

    mask = np.zeros(1 << 14, dtype=bool)
    mask[5] = True
    idx, n = _packed_nonzero(jnp.asarray(mask), 64)
    assert int(n) == 1 and int(idx[0]) == 5
    # beyond-count entries stay in-bounds (callers mask by count)
    assert np.all(np.asarray(idx) < mask.shape[0])


def test_device_scanner_streaming_slabs_match_numpy():
    """With a tiny HBM budget, the scanner streams the database through the
    device in target slabs; hits, mismatch counts and per-guide target order
    must equal the resident scan exactly."""
    genome = random_genome(80000, seed=33)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[3000:3700])]),
                               Cas9NGGParameterPack)
    guides = np.asarray(gsites.sequences)

    resident = DeviceScanner(db, use_pallas=False, chunk=1 << 12)
    assert resident.codes is not None
    budget = 32 * (1 << 12) * 2  # two chunks of code planes
    streaming = DeviceScanner(db, use_pallas=False, chunk=1 << 12,
                              hbm_budget=budget)
    assert streaming.codes is None, "tiny budget must force streaming"
    assert streaming.slab_n < db.num_targets, "multiple slabs expected"

    def collect(sc):
        got = {}
        for t_idx, g_idx, mm in sc.scan(guides, 4):
            for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
                got.setdefault(g, []).append((t, m))
        return got

    a, b = collect(resident), collect(streaming)
    assert a == b
    for g, hits in b.items():
        ts = [t for t, _ in hits]
        assert ts == sorted(ts)


def test_device_plane_codes_matches_host():
    """Device-side word expansion must reproduce plane_codes exactly,
    including PAD_CODE padding columns and the masked tail slab."""
    from flashfry_tpu.ops.scan import (PAD_CODE, device_plane_codes,
                                       plane_codes)
    rng = np.random.default_rng(3)
    for n, n_pad, slab in ((1000, 1 << 12, 1 << 10), (0, 1 << 10, 1 << 10),
                           (1 << 12, 1 << 12, 1 << 12)):
        targets = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
        want = plane_codes(targets, 23, n_pad)
        got = np.asarray(device_plane_codes(targets, 23, n_pad, slab))
        assert got.shape == want.shape
        assert np.array_equal(got, want)
        assert (got[:, n:] == PAD_CODE).all()


def test_two_phase_slice_fetch_matches_whole_buffer():
    """Forcing the count-first bucketed slice fetch (normally only for
    >512k-slot buffers) must yield identical triplets to the whole-buffer
    fetch, including across cap-overflow retries."""
    genome = random_genome(60000, seed=77)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[1000:1800])]),
                               Cas9NGGParameterPack)
    guides = np.asarray(gsites.sequences)

    def collect(**kw):
        sc = DeviceScanner(db, use_pallas=False, chunk=1 << 13)
        for k, v in kw.items():
            setattr(sc, k, v)
        return [(t, g, m)
                for ti, gi, mi in sc.scan(guides, 4)
                for t, g, m in zip(ti.tolist(), gi.tolist(), mi.tolist())]

    whole = collect()
    sliced = collect(FETCH_SLICE_MIN=0)
    assert sliced == whole and len(whole) > 0


def test_caps_escalate_per_max_mismatch():
    """Cap escalation at one max_mismatch must not inflate the buffers of
    scans at another (per-mm sticky caps)."""
    genome = random_genome(40000, seed=78)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[500:1500])]),
                               Cas9NGGParameterPack)
    guides = np.asarray(gsites.sequences)
    sc = DeviceScanner(db, use_pallas=False, chunk=1 << 12, trip_cap=8)
    n8 = sum(len(t) for t, _, _ in sc.scan(guides, 8))   # escalates hard
    assert n8 > 8
    assert sc._caps[8][1] > sc._trip0
    n4_trip0_before = sc._caps.get(4, (sc._cap0, sc._trip0))[1]
    assert n4_trip0_before == sc._trip0  # mm=4 caps untouched by mm=8


def test_interleaved_blocks_shape_and_coverage():
    from flashfry_tpu.ops.scan import interleaved_blocks
    for n, block in [(0, 128), (1, 128), (128, 128), (129, 128), (1000, 128)]:
        blocks = interleaved_blocks(n, block)
        flat = np.concatenate(blocks) if blocks else np.zeros(0, np.int64)
        assert sorted(flat.tolist()) == list(range(n))
        assert all(b.size <= block for b in blocks)


def test_multi_block_sorted_hot_cluster_matches_oracle():
    """A SORTED guide set with a planted hot cluster (many near-identical
    guides, the repeat-family shape that OOM'd the un-interleaved scan)
    must still produce exactly the oracle hit set across multiple guide
    blocks, with per-guide target-major order."""
    from flashfry_tpu.standards import Cas9NGGParameterPack as pack
    genome = random_genome(120000, seed=5)
    # plant a 60-copy repeat of one 300 bp unit, lightly mutated
    rng = np.random.default_rng(9)
    unit = "".join("ACGT"[c] for c in rng.integers(0, 4, size=300))
    g = list(genome)
    for _ in range(60):
        p = int(rng.integers(0, len(genome) - 300))
        u = list(unit)
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, 300))
            u[q] = "ACGT"[int(rng.integers(0, 4))]
        g[p:p + 300] = u
    genome = "".join(g)
    db = build_db(genome, pack)
    enc = db.bit_encoding()

    # guides = a SORTED sample of db targets (the clustering worst case):
    # block size is 128, so >=3 blocks
    idx = np.sort(np.random.default_rng(3).choice(
        db.num_targets, size=300, replace=False))
    guide_longs = db.targets[idx]

    scanner = DeviceScanner(db, use_pallas=False, chunk=1 << 14, cap=8,
                            trip_cap=64)  # tiny caps: escalation exercised
    got = {}
    for t_idx, g_idx, mm in scanner.scan(np.asarray(guide_longs), 4):
        for t, gg, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(gg, []).append((t, m))

    expect_mm = enc.mismatches_cross(
        np.asarray(guide_longs, dtype=np.uint64), db.targets)
    for gi in range(guide_longs.shape[0]):
        t_hits = np.nonzero(expect_mm[gi] <= 4)[0]
        expect = [(int(t), int(expect_mm[gi, t])) for t in t_hits]
        assert got.get(gi, []) == expect


def test_adaptive_emit_big_branch_matches_oracle():
    """Force a per-chunk hit count ABOVE the adaptive emit's small cap
    (block_cap // 8) so the WIDE lax.cond branch runs, and pin the result
    to the oracle. A repeat family (many identical targets) matched by
    many near-identical guides makes k = hit_cols x hit_guides per chunk
    large while staying under the caps."""
    from flashfry_tpu.bitcoding import BitEncoding
    from flashfry_tpu.standards import Cas9NGGParameterPack as pack

    rng = np.random.default_rng(77)
    unit = "".join("ACGT"[c] for c in rng.integers(0, 4, size=21)) + "GG"
    # 400 DISTINCT 1-mismatch variants of one site (exact copies would
    # dedup to a single database target) embedded in random sequence
    genome = []
    for _ in range(400):
        genome.append("".join("ACGT"[c] for c in rng.integers(0, 4, size=40)))
        var = list(unit[:21])
        p = int(rng.integers(0, 21))
        var[p] = "ACGT"[int(rng.integers(0, 4))]
        genome.append("".join(var) + "GG")
    db = build_db("".join(genome), pack)

    # 64 guides, each within 1 mismatch of the family: every (guide,
    # family-target) pair hits at mm <= 2
    guides = []
    for i in range(64):
        mut = list(unit[:21])
        mut[i % 21] = "ACGT"[(("ACGT".index(mut[i % 21])) + 1 + i // 21) % 4]
        guides.append("".join(mut) + "GG")
    enc = BitEncoding(pack)
    guide_longs = enc.encode_batch(guides)

    # cap=1<<11 -> block_cap = 8 * 2048 = 16384, small_cap = 2048. A 21-mer
    # has only 63 distinct 1-mismatch variants, so the 400 draws dedup to
    # ~64 family targets: k ~= 64 targets x 64 guides ~= 4096 > small_cap.
    # chunk must cover the WHOLE db so that per-chunk k == total n_hits and
    # the guard below really certifies the wide branch ran.
    scanner = DeviceScanner(db, use_pallas=False, chunk=1 << 14, cap=1 << 11,
                            trip_cap=1 << 17)
    assert scanner.chunk >= db.num_targets, \
        "db must fit one chunk for the per-chunk-k guard to be valid"
    got = {}
    n_hits = 0
    for t_idx, g_idx, mm in scanner.scan(np.asarray(guide_longs), 4):
        n_hits += t_idx.size
        for t, g, m in zip(t_idx.tolist(), g_idx.tolist(), mm.tolist()):
            got.setdefault(g, []).append((t, m))
    small_cap = (8 * (1 << 11)) // 8
    assert n_hits > small_cap, "test no longer exercises the wide branch"

    expect_mm = enc.mismatches_cross(
        np.asarray(guide_longs, dtype=np.uint64), db.targets)
    for g in range(len(guides)):
        t_hits = np.nonzero(expect_mm[g] <= 4)[0]
        expect = [(int(t), int(expect_mm[g, t])) for t in t_hits]
        assert got.get(g, []) == expect


def test_searchsorted_monotone_matches_numpy():
    """Direct fuzz of the two-level search against np.searchsorted 'left',
    including ties, zero runs, all-below/all-above queries, and non-window-
    multiple lengths (padded with int32 max)."""
    from flashfry_tpu.ops.scan import _searchsorted_monotone
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for nt, kq in ((16384, 65536), (1000, 777), (128, 4096), (5, 64)):
        steps = rng.integers(0, 4, size=nt)
        steps[rng.random(nt) < 0.3] = 0  # long tie runs
        cum = np.cumsum(steps).astype(np.int32)
        q = rng.integers(-2, int(cum[-1]) + 3, size=kq).astype(np.int32)
        got = np.asarray(_searchsorted_monotone(jnp.asarray(cum),
                                                jnp.asarray(q)))
        want = np.searchsorted(cum, q, side="left")
        assert np.array_equal(got, want), (nt, kq)


def test_max_guide_block_env(monkeypatch):
    from flashfry_tpu.ops.scan import max_guide_block
    monkeypatch.delenv("FLASHFRY_TPU_MAX_BLOCK", raising=False)
    assert max_guide_block() == 2048
    for raw, want in (("1024", 1024), ("3000", 2048), ("1500", 1024),
                      ("64", 128), ("8192", 8192)):
        monkeypatch.setenv("FLASHFRY_TPU_MAX_BLOCK", raw)
        assert max_guide_block() == want, raw


def test_auto_backend_does_not_hide_a_broken_runtime(monkeypatch):
    """--backend auto runs the numpy oracle only on a CPU-only runtime; a
    runtime that cannot report its platform raises instead of silently
    falling back to the host scan."""
    from flashfry_tpu import engine
    from flashfry_tpu.ops import scan as S
    genome = random_genome(20000, seed=4)
    db = build_db(genome, Cas9NGGParameterPack)
    gsites = find_target_sites(iter([("g", genome[:400])]),
                               Cas9NGGParameterPack)
    assert not engine._on_accelerator()          # this suite runs on the CPU

    def broken():
        raise RuntimeError("backend failed to initialize")

    monkeypatch.setattr(S, "default_device", broken)
    with pytest.raises(RuntimeError, match="failed to initialize"):
        engine.discover(db, gsites, max_mismatch=3, backend="auto")


def test_brute_force_hits_chunks_match_whole():
    """The chunked brute-force oracle equals one unchunked comparison."""
    from flashfry_tpu.engine import brute_force_hits
    genome = random_genome(40000, seed=6)
    db = build_db(genome, Cas9NGGParameterPack)
    enc = db.bit_encoding()
    g = int(db.targets[db.num_targets // 3])
    idx, mm = brute_force_hits(db, g, 4, chunk=1000)
    whole = enc.mismatches_cross(np.asarray([g], np.uint64), db.targets)[0]
    want = np.nonzero(whole <= 4)[0]
    assert np.array_equal(idx, want) and np.array_equal(mm, whole[want])
    assert idx.size >= 1
