"""Accelerator mismatch scan: one-hot matmuls.

This is the data-parallel re-formulation of the reference's hot loop
(reference: reference/binary/blocks/BlockManager.scala:212-254 — per-target,
per-guide XOR + masked popcount; and the abandoned GPU formulation at
java/bitcoding/GPUBitBlockCompare.java). Instead of translating the scalar
popcount loop, we observe that for 2-bit base codes

    mismatches(g, t) = |active(g)| - <onehot(g), onehot(t)>

where onehot(x) is the 4L-wide one-hot expansion of the L bases and the guide
side is zeroed at PAM/masked positions. The inner product over a batch of
guides and a block of targets is a (G, 4L) x (4L, T) matmul, which the GPU's
tensor cores take at int8. The products are exact (0/1 values, sums <= 24).

Device data layout: the database lives in device memory as PLANE-MAJOR base
codes, a (32, N) int8 array (row i = base i of every target, rows >= L
zero). The packed-int64 form is only a host format.

Whole-database scans run as ONE device dispatch (a fori_loop over chunks with
on-device hit compaction); the only device->host traffic per guide block is a
single fixed-size int32 buffer holding the packed (target, guide, mm)
triplets plus a count/overflow header.

Every result here is an integer: the float stage-1 and stage-2 products cast
their 0/1 operands to bf16 with float32 accumulation, exact for sums <= 24,
and the int8 products accumulate in int32. No TF32 product is taken, so the
device scan equals the numpy oracle exactly at any matmul precision setting.
"""

from __future__ import annotations

import functools
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..bitcoding import STRING_MASK
from ..database import Database
from ..standards import ParameterPack

_PAD_MM = 127  # mismatch count assigned to guide padding rows

# persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path inside the checkout (git-ignored), so a later run finds it again
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

_cache_enabled = False


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: the scan kernels compile once per
    (shape, enzyme) and are reused across CLI invocations. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
    here; otherwise the cache is COMPILE_CACHE_DIR. Opt out with
    FLASHFRY_TPU_NO_COMPILE_CACHE=1."""
    global _cache_enabled
    if _cache_enabled:
        return
    _cache_enabled = True
    if (os.environ.get("FLASHFRY_TPU_NO_COMPILE_CACHE")
            or os.environ.get("JAX_COMPILATION_CACHE_DIR")):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


def default_device():
    """The device jax places arrays on (honors jax_default_device)."""
    import jax
    d = jax.config.jax_default_device
    return d if d is not None else jax.devices()[0]


def default_platform() -> str:
    return default_device().platform


def use_stage1_kernel(platform: str) -> bool:
    """Which stage 1 runs on `platform`: the fused Pallas kernel
    (ops/scan_kernel.py) on the GPU, the plain jnp formulation on the CPU
    (the reference the kernel is tested against). Any other platform is an
    error, not a silent fallback."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError("no stage-1 scan path for platform %r" % platform)


# ---------------------------------------------------------------------------
# host-side preparation
# ---------------------------------------------------------------------------

CODE_ROWS = 32  # plane rows (L <= 24, padded to 32)


def split_words(longs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 -> (lo32, hi16) as int32 arrays (sequence bits only)."""
    seq = np.asarray(longs, dtype=np.uint64) & STRING_MASK
    lo = (seq & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (seq >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


PAD_CODE = 4  # padding-column base code: matches no one-hot row, never hits


def plane_codes(longs: np.ndarray, L: int, n_pad: Optional[int] = None) -> np.ndarray:
    """Packed int64 targets -> (32, N_pad) int8 plane-major base codes.

    Row i holds base i (0..3) of every target; rows >= L are zero. Padding
    COLUMNS (targets beyond n) hold PAD_CODE everywhere: their one-hot
    expansion is all-zero, so they can never reach the stage-1 threshold —
    which lets the fused scan skip a whole per-chunk validity-mask pass.
    This is the device-resident database layout (see module docstring)."""
    seq = np.asarray(longs, dtype=np.uint64) & STRING_MASK
    n = seq.shape[0]
    if n_pad is None:
        n_pad = n
    out = np.zeros((CODE_ROWS, n_pad), dtype=np.int8)
    for i in range(L):
        s = np.uint64(2 * (L - 1 - i))
        out[i, :n] = ((seq >> s) & np.uint64(3)).astype(np.int8)
    out[:, n:] = PAD_CODE
    return out


def guide_onehot_matrix(guide_longs: np.ndarray, pack: ParameterPack,
                        pad_to: int = 128) -> Tuple[np.ndarray, np.ndarray, int]:
    """(G_pad, 4L) float32 one-hot guide matrix, masked positions zeroed.

    Returns (onehot, n_active_adj, G) where n_active_adj[g] is |active|
    for real guides and _PAD_MM for padding rows (so padding never 'hits').
    """
    L = pack.total_scan_length
    active = pack.comparison_mask_positions()
    g = np.asarray(guide_longs, dtype=np.uint64) & STRING_MASK
    G = g.shape[0]
    Gp = max(pad_to, int(np.ceil(G / pad_to)) * pad_to)
    onehot = np.zeros((Gp, 4 * L), dtype=np.float32)
    for i in active:
        shift = np.uint64(2 * (L - 1 - i))
        codes = ((g >> shift) & np.uint64(3)).astype(np.int64)
        onehot[np.arange(G), 4 * i + codes] = 1.0
    n_active = np.full(Gp, _PAD_MM, dtype=np.float32)
    n_active[:G] = len(active)
    return onehot, n_active, G


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def codes_onehot_jnp(codes, L: int):
    """(32, T) int8 plane codes -> (4L, T) bf16 one-hot."""
    import jax.numpy as jnp
    c = codes[:L].astype(jnp.int32)                                 # (L, T)
    oh = (c[:, None, :] == jnp.arange(4, dtype=jnp.int32)[None, :, None])
    return oh.reshape(4 * L, -1).astype(jnp.bfloat16)


def stage1_plain(codes_chunk, guide_bf, L: int, thr: int):
    """The plain stage 1 XLA compiles: a bf16 one-hot dot with float32
    accumulation (exact: 0/1 products, sums <= 24), thresholded per target.
    (32, T) int8 codes, (G, 4L) bf16 guides -> (T,) bool. The (G, T) match
    matrix goes through device memory; the GPU runs the fused kernel
    instead (scan_kernel.py), and this is its reference and the CPU path.
    (XLA's int8 dot with int32 accumulation plus max, the other plain
    formulation, was slower than this one on the H100; PERF.md.)"""
    import jax
    import jax.numpy as jnp
    t_oh = codes_onehot_jnp(codes_chunk, L)
    m = jax.lax.dot(guide_bf, t_oh, preferred_element_type=jnp.float32)
    return (m >= float(thr)).any(axis=0)


def _searchsorted_monotone(cum, q, window: int = 128):
    """Left insertion points of q into nondecreasing cum, as a two-level
    DIRECT search: count supertiles wholly below each query (one dense
    (k, ns) compare-sum), gather the one straddling window per query, rank
    inside it (one (k, W) compare-sum). Replaces jnp.searchsorted, whose
    log2(nt) rounds of random gathers scale with QUERY COUNT (the fused
    scan issues 65536 triplet queries per chunk). Exact for any
    nondecreasing cum (ties -> leftmost, as 'left' does)."""
    import jax.numpy as jnp
    nt = cum.shape[0]
    if nt % window:
        pad = window - nt % window
        cum = jnp.concatenate(
            [cum, jnp.full((pad,), jnp.iinfo(cum.dtype).max, cum.dtype)])
        nt = cum.shape[0]
    ns = nt // window
    cum2 = cum.reshape(ns, window)
    super_last = cum2[:, -1]                                   # (ns,)
    s = (super_last[None, :] < q[:, None]).sum(axis=1)         # (k,)
    s = jnp.minimum(s, ns - 1)
    win = cum2[s]                                              # (k, W) gather
    pos = (win < q[:, None]).sum(axis=1)
    return s * window + pos


def _tile_select(m2, tcnt, tile_cum, size: int, tile: int, n_el: int):
    """Indices of the first `size` set bits, given precomputed per-tile
    structure (m2 (nt, tile) mask, tcnt per-tile counts, tile_cum their
    cumsum). Entries beyond the true count clamp to n_el - 1. Shared by
    _packed_nonzero and the fused scan's adaptive triplet emit (which
    computes the tile counts once and selects at two widths)."""
    import jax.numpy as jnp
    nt = m2.shape[0]
    q = jnp.arange(1, size + 1, dtype=jnp.int32)      # k-th hit, 1-based
    qt = _searchsorted_monotone(tile_cum, q)          # its tile (first
    qt = jnp.minimum(qt, nt - 1)                      #  cum >= k has tcnt>0)
    r = q - (tile_cum[qt] - tcnt[qt])                 # rank within tile
    rows = m2[qt].astype(jnp.int32)                   # (size, tile) gather
    lc = jnp.cumsum(rows, axis=1)
    pos = jnp.sum(lc < r[:, None], axis=1)            # first lc >= r
    idx = qt * tile + pos
    return jnp.minimum(idx, n_el - 1).astype(jnp.int32)


def _packed_nonzero(mask, size: int, tile: int = 512):
    """Indices of the first `size` set bits of a 1-D bool array, packed.

    Equivalent to jnp.nonzero(mask, size=size) but without the n-element
    scatter and without a full-length cumsum + a binary search per query.
    Two-level instead:

      1. per-tile hit counts (one reduce pass) + a tiny cumsum over n/T tiles;
      2. searchsorted over the TILE cumsum locates the tile of the k-th hit;
      3. gather just the `size` relevant tiles and rank within each row with
         a short cumsum along the tile.

    All passes touch O(n) bytes once plus O(size*T) for the ranking.
    Returns (idx int32[size] — entries beyond the true count clamp to n-1,
    count int32). Indices ascend; ties with the flat formulation are exact
    (tests/test_scan_jax.py::test_packed_nonzero_*).

    tile: the ranking-gather row width. 512 suits few queries over a big
    mask (stage-1 column compaction: size=8k over 8M). For MANY queries
    (stage-2 triplet compaction, size=64k) the (size, tile) gather
    dominates, and tile=128 moves 4x less."""
    import jax.numpy as jnp
    n_el = mask.shape[0]
    T = tile
    if n_el % T or n_el <= 2 * T:
        cnt = jnp.cumsum(mask.astype(jnp.int32))
        idx = jnp.searchsorted(cnt, jnp.arange(1, size + 1, dtype=jnp.int32),
                               side="left")
        return jnp.minimum(idx, n_el - 1).astype(jnp.int32), cnt[-1]
    nt = n_el // T
    m2 = mask.reshape(nt, T)
    tcnt = m2.sum(axis=1, dtype=jnp.int32)                    # (nt,)
    tile_cum = jnp.cumsum(tcnt)                               # (nt,)
    n = tile_cum[-1]
    return _tile_select(m2, tcnt, tile_cum, size, T, n_el), n


def make_fused_scan(L: int, n_act: int, max_mm: int, chunk: int, g_rows: int,
                    n_chunks: int, col_cap: int, trip_cap: int,
                    use_pallas: bool, stage2_int8: bool = True,
                    trip_tile: int = 128, interpret: bool = False):
    """Whole-database scan in ONE device dispatch (untraced; see
    _fused_scan_jit for the jitted single-device form and
    parallel.mesh.ShardedScanner for the shard_map multi-chip form).

    A lax.fori_loop walks every chunk: stage-1 hit detection (the Pallas
    kernel on the GPU, jnp on the CPU), on-device column compaction, exact
    mismatch recount for the hit columns, then flat compaction of (target,
    guide, mm) triplets appended to a global buffer. Returns a single
    (2, trip_cap + block_cap + 2) int32 buffer — row 0 = target idx, row 1 =
    guide_idx << 8 | mm, with [0, -2] = triplet count and [0, -1] = overflow
    flag — so ONE fetch moves everything to the host.

    Triplets are ordered (chunk, target, guide) = global target-major, the
    order FlashFry applies hits in (reference/traverser/SeekTraverser.scala:
    58-104).

    col_cap: max stage-1 hit targets per chunk; trip_cap: max total triplets.
    If either overflows, the overflow flag is set and the caller retries with
    larger caps.

    Stage 1 must not be coarsened over guide-PAIR union one-hots: the
    per-COLUMN false-positive rate is 1 - (1 - p_pair)^(G/2) with p_pair
    ~ 1e-3, i.e. ~40% of all targets fire at G=1024, swamping the
    compaction. Any stage-1 coarsening must keep the per-column FP rate ~G
    times smaller than the per-row rate.

    CONTRACT: codes_full's padding columns (beyond the real target count)
    MUST hold PAD_CODE, as plane_codes produces. Their one-hot expansion is
    all-zero so they can never reach the stage-1 threshold; there is no
    validity-mask pass and a zero-padded (poly-A-looking) code array would
    emit phantom hits.
    """
    import jax
    import jax.numpy as jnp

    if (col_cap * g_rows) % trip_tile:
        raise ValueError(
            "FLASHFRY_TPU_TRIP_TILE=%d must divide col_cap*g_rows=%d "
            "(the stage-2 compaction domain)" % (trip_tile, col_cap * g_rows))

    thr = max(n_act - max_mm, 1)

    if use_pallas:
        from .scan_kernel import stage1_pallas
        # ONE kernel call whose grid spans EVERY chunk: the kernel reads
        # tiles straight from the resident array, where a call per chunk
        # first copies each chunk's dynamic_slice (4-8% slower per scan on
        # an H100, PERF.md); the loop then slices only the 1 B/target hit
        # bytes.
        inner_all = stage1_pallas(n_act, max_mm, n_chunks * chunk, g_rows,
                                  interpret)

    # per-chunk triplet block size: nonzero packs real hits first, so the
    # block is appended with one contiguous dynamic_update_slice (a plain
    # copy, no scatter). The buffer is over-allocated by a block so the
    # append window never clamps. 8x the column cap: on a repeat-rich genome
    # one hit column matches MANY guides of the same family in the block
    # (k per chunk >> n_cols), and since k > block_cap raises the COLUMN
    # overflow flag, a tight multiplier spuriously escalates col_cap —
    # quadrupling the stage-2 (col_cap, G) domain. 8x keeps genuine column
    # overflows detectable.
    block_cap = min(trip_cap, col_cap * 8)
    width = trip_cap + block_cap + 2

    def f(codes_full, guide_oh, n_active):
        from .scan_kernel import guide_block_layout
        guide_bf = guide_oh.astype(jnp.bfloat16)                   # (G, 4L)
        guide_bf_T = guide_bf.T                                    # (4L, G)
        guide_i8 = guide_block_layout(guide_oh, L)                 # (G, 128)

        if use_pallas:
            hits_all = inner_all(codes_full, guide_i8)             # (N,) bool

        def body(c, carry):
            count, col_of, trip_of, buf = carry
            start = c * chunk
            # padding columns hold PAD_CODE (all-zero one-hot) so they can
            # never hit: no (idx < n_targets) mask pass is needed
            if use_pallas:
                hit = jax.lax.dynamic_slice_in_dim(hits_all, start, chunk)
            else:
                codes_chunk = jax.lax.dynamic_slice_in_dim(
                    codes_full, start, chunk, axis=1)
                hit = stage1_plain(codes_chunk, guide_bf, L, thr)  # (chunk,)
            cols, n_cols = _packed_nonzero(hit, col_cap)
            gcols = start + cols                                   # global idx
            # exact mismatch counts for the hit columns, gathered straight
            # from the FULL resident array (no chunk slab copy) in the
            # (cap, G) orientation: transposing the small (32, cap) int8
            # code selection instead of a (G, cap) int32 matches matrix
            # moves ~128x less data (268 MB/chunk at mm=5-escalated caps)
            selT = codes_full[:, gcols].T                          # (cap, 32)
            if stage2_int8:
                # int8 recount in the SAME block layout as stage 1 (column
                # b*32+i, guide_block_layout): the one-hot is four int32
                # compares over the gathered selection and the matmul runs
                # against guide_i8 directly — no bf16 guide transpose, exact
                # int32 counts (products are 0/1, sums <= 24)
                sel32 = selT.astype(jnp.int32)                     # (cap, 32)
                t_ohT = jnp.concatenate(
                    [(sel32 == b).astype(jnp.int8) for b in range(4)],
                    axis=1)                                        # (cap, 128)
                matches = jax.lax.dot(t_ohT, guide_i8.T,
                                      preferred_element_type=jnp.int32)
                mmT = jnp.minimum(
                    n_active[None, :].astype(jnp.int32) - matches, _PAD_MM)
            else:
                t_ohT = (selT[:, :L, None] ==
                         jnp.arange(4, dtype=selT.dtype)).reshape(col_cap, 4 * L)
                matches = jax.lax.dot(t_ohT.astype(jnp.bfloat16), guide_bf_T,
                                      preferred_element_type=jnp.float32)
                mmT = jnp.minimum(n_active[None, :] - matches, _PAD_MM)
            col_ok = jnp.arange(col_cap) < n_cols
            hits2d = (mmT <= max_mm) & col_ok[:, None]             # (cap, G)
            mask = hits2d.reshape(-1)
            n_el = mask.shape[0]
            nt = n_el // trip_tile
            m2 = mask.reshape(nt, trip_tile)
            tcnt = m2.sum(axis=1, dtype=jnp.int32)
            tile_cum = jnp.cumsum(tcnt)
            k = tile_cum[-1]                                       # true count
            safe = jnp.minimum(count, trip_cap)

            def emit(size, buf):
                # select/gather/append at a given emit width; shares the
                # tile counts computed once above
                flat = _tile_select(m2, tcnt, tile_cum, size, trip_tile, n_el)
                g_idx = (flat % g_rows).astype(jnp.int32)
                t_idx = gcols[flat // g_rows].astype(jnp.int32)
                mm_v = mmT.reshape(-1)[flat].astype(jnp.int32)
                block = jnp.stack([t_idx, (g_idx << 8) | mm_v])    # (2, size)
                return jax.lax.dynamic_update_slice(buf, block, (0, safe))

            # adaptive emit width: the query/rank machinery scales with the
            # EMIT CAP, not the hit count, and block_cap is provisioned for
            # the worst repeat-heavy chunk (8x col_cap) while typical chunks
            # carry a few thousand hits — they take an 8x narrower branch
            small_cap = block_cap // 8
            if small_cap >= 1024 and small_cap < block_cap:
                buf = jax.lax.cond(k <= small_cap,
                                   functools.partial(emit, small_cap),
                                   functools.partial(emit, block_cap), buf)
            else:
                buf = emit(block_cap, buf)
            count = count + k
            col_of = col_of | (n_cols > col_cap) | (k > block_cap)
            trip_of = trip_of | (k > block_cap) | (count > trip_cap)
            return count, col_of, trip_of, buf

        carry = (jnp.int32(0), jnp.bool_(False), jnp.bool_(False),
                 jnp.zeros((2, width), jnp.int32))
        count, col_of, trip_of, buf = jax.lax.fori_loop(0, n_chunks, body, carry)
        buf = buf.at[0, width - 2].set(count)
        buf = buf.at[0, width - 1].set(col_of.astype(jnp.int32)
                                       | (trip_of.astype(jnp.int32) << 1))
        return buf

    return f


@functools.lru_cache(maxsize=16)
def _fused_scan_jit(L: int, n_act: int, max_mm: int, chunk: int, g_rows: int,
                    n_chunks: int, col_cap: int, trip_cap: int,
                    use_pallas: bool, stage2_int8: bool = True,
                    trip_tile: int = 128, interpret: bool = False):
    import jax
    return jax.jit(make_fused_scan(L, n_act, max_mm, chunk, g_rows, n_chunks,
                                   col_cap, trip_cap, use_pallas,
                                   stage2_int8, trip_tile, interpret))


def parse_trip_buffer(buf: np.ndarray):
    """Decode a fused-scan triplet buffer -> (t_idx, g_idx, mm, count,
    overflow). overflow is a bitmask: 1 = per-chunk column cap tripped,
    2 = total triplet cap tripped."""
    count = int(buf[0, -2])
    overflow = int(buf[0, -1])
    n = 0 if overflow else count
    packed = buf[1, :n]
    return (buf[0, :n].astype(np.int64), (packed >> 8).astype(np.int64),
            (packed & 0xFF).astype(np.int8), count, overflow)


# stage-2 recount configuration (module globals read at dispatch time so
# benchmarks can A/B them; env-overridable for field debugging)
STAGE2_INT8 = os.environ.get("FLASHFRY_TPU_STAGE2", "int8") != "bf16"
TRIP_TILE = int(os.environ.get("FLASHFRY_TPU_TRIP_TILE", "128"))


def max_guide_block() -> int:
    """Max guides per scan block (env FLASHFRY_TPU_MAX_BLOCK, default 2048
    — see the block-size history note in DeviceScanner.scan). The single
    source for DeviceScanner, ShardedScanner and the bench presize, floored
    to a power of two >= 128 so the doubling loop treats it as a true cap
    (a raw 3000 would otherwise overshoot to 4096)."""
    v = int(os.environ.get("FLASHFRY_TPU_MAX_BLOCK", "2048"))
    return max(128, 1 << (max(v, 1).bit_length() - 1))


# Targets per fused-loop chunk, the stage-2 compaction window. The kernel
# path needs a multiple of its T_TILE; 2^23 was fastest or within noise of
# 2^21-2^24 at mm=4 and 5 on an H100 (PERF.md). The plain jnp stage 1
# materializes a (G, chunk) float32 match matrix per chunk, so its chunk is
# smaller: 2^20 keeps that matrix at 8 GiB for G=2048.
DEFAULT_CHUNK = 1 << 23
PLAIN_CHUNK = 1 << 20
PIPELINE_DEPTH = 3      # in-flight fused dispatches (double/triple buffering)
DEFAULT_CAP = 1 << 12   # max stage-1 hit targets per chunk
TRIPLET_CAP = 1 << 17   # max (guide, target) hit pairs per fused block scan
MAX_RETRIES = 6         # cap-escalation retries before the exact host
                        # fallback (col steps x2, so a 4096->65536 climb
                        # takes 4; each retry re-dispatches one guide block)
COL_CAP_MAX = 1 << 16   # ceiling: stage-2 (col_cap, G) int32 matches + mmT
                        # = 2 x 512 MB at the ceiling with the default
                        # G=2048 blocks; scan_working_set_bytes reserves it
                        # beside the code planes. Past it the chunk shrinks.
TRIP_CAP_MAX = 1 << 25  # ceiling: 268 MB triplet buffer per in-flight block


def interleaved_blocks(n_guides: int, block: int):
    """Deal guide indices round-robin into ceil(n/block) blocks.

    Guide batches often arrive SEQUENCE-SORTED (library FASTAs decoded from
    a sorted database, bench samples), which packs whole repeat families —
    hundreds of near-identical guides — into single contiguous blocks: that
    block's stage-1 hit-column and triplet counts explode while every other
    block idles (a 100k-guide hg38-scale library run escalated col_cap to
    2^20 and ran out of device memory on the 4 GB stage-2 matrix). Round-robin
    dealing spreads any sorted hot cluster evenly across blocks. Per-guide
    output order is unaffected: each guide lives in exactly one block and
    yields its hits target-major; the collector re-groups by guide index.
    """
    n_blocks = max(1, -(-max(n_guides, 1) // block))
    return [np.arange(b, n_guides, n_blocks, dtype=np.int64)
            for b in range(n_blocks)]


def scan_chunk(use_pallas: bool, chunk: Optional[int] = None) -> int:
    """The chunk a scan runs at: DEFAULT_CHUNK on the kernel path,
    PLAIN_CHUNK on the plain one, or the caller's; the kernel path rounds it
    down to a multiple of the kernel's T_TILE (at least one tile)."""
    from .scan_kernel import T_TILE
    if chunk is None:
        chunk = DEFAULT_CHUNK if use_pallas else PLAIN_CHUNK
    if use_pallas and chunk % T_TILE:
        chunk = max(T_TILE, (chunk // T_TILE) * T_TILE)
    return chunk


def min_scan_chunk(use_pallas: bool) -> int:
    """The smallest chunk a column-cap overflow may shrink to."""
    from .scan_kernel import T_TILE
    return T_TILE if use_pallas else (1 << 16)


CPU_CODE_BUDGET = 13 << 30  # the CPU has no device memory limit to read


def scan_working_set_bytes(chunk: int, use_pallas: bool,
                           g_rows: Optional[int] = None) -> int:
    """Device memory the scan needs beside the resident code planes, at
    the cap ceilings: the stage-2 (col_cap, G) int32 matches, mismatch and
    mask domain, PIPELINE_DEPTH in-flight triplet buffers, the int32 row
    temporaries of one expansion slab, the plain stage 1's (G, chunk)
    float32 match matrix when it runs, and 1 GiB of XLA scratch."""
    g = max_guide_block() if g_rows is None else g_rows
    stage2 = 3 * 4 * COL_CAP_MAX * g
    trips = PIPELINE_DEPTH * 2 * 4 * (TRIP_CAP_MAX + 8 * COL_CAP_MAX)
    expand = 2 * 4 * CODE_ROWS * chunk
    stage1 = 0 if use_pallas else 4 * g * chunk
    return stage2 + trips + expand + stage1 + (1 << 30)


def hbm_budget_bytes(working_set: int = 0) -> int:
    """Device-memory budget for the resident code planes: the default
    device's bytes_limit less the scan's working set. On the CPU (tests) a
    fixed CPU_CODE_BUDGET. FLASHFRY_TPU_HBM_BUDGET_GB overrides both. An
    accelerator that does not report its limit is an error: no size is
    assumed for it."""
    gb = os.environ.get("FLASHFRY_TPU_HBM_BUDGET_GB")
    if gb:
        return int(float(gb) * (1 << 30))
    dev = default_device()
    if dev.platform == "cpu":
        return CPU_CODE_BUDGET
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            "%s reports no memory limit; set FLASHFRY_TPU_HBM_BUDGET_GB" % dev)
    return int(stats["bytes_limit"]) - working_set


@functools.lru_cache(maxsize=4)
def _expand_codes_jit(L: int, slab: int):
    """Jitted (buf (32, N) int8, lo (slab,) i32, hi (slab,) i32, start i32,
    n_valid i32) -> buf with columns [start, start+slab) filled.

    Decodes 2-bit packed words into plane-major base codes ON DEVICE, so the
    host uploads 8 bytes/target instead of 32 bytes of pre-expanded planes
    and never builds the 32-byte planes itself. buf is donated so the update
    aliases in place (no second 12 GB buffer); columns >= n_valid keep
    PAD_CODE."""
    import jax
    import jax.numpy as jnp

    def fill(buf, lo, hi, start, n_valid):
        rows = []
        for i in range(L):
            s = 2 * (L - 1 - i)  # bases never straddle the 32-bit split
            w = lo if s < 32 else hi
            rows.append((jax.lax.shift_right_logical(w, s % 32) & 3))
        codes = jnp.stack(rows).astype(jnp.int8)              # (L, slab)
        codes = jnp.pad(codes, ((0, CODE_ROWS - L), (0, 0)))
        valid = jnp.arange(slab, dtype=jnp.int32) < n_valid
        codes = jnp.where(valid[None, :], codes, jnp.int8(PAD_CODE))
        return jax.lax.dynamic_update_slice(buf, codes, (0, start))

    return jax.jit(fill, donate_argnums=(0,))


def device_plane_codes(targets: np.ndarray, L: int, n_pad: int, slab: int):
    """Packed int64 targets -> (32, n_pad) int8 plane codes resident on the
    default device, built by streaming packed words (8 B/target) and
    expanding on device (see _expand_codes_jit). slab must divide n_pad
    (callers pass their chunk size, which already tiles n_pad) so one
    fixed-shape executable serves every slab; the tail slab masks its
    invalid columns and fully-padded slabs are skipped (the initial fill is
    already PAD_CODE)."""
    import jax
    import jax.numpy as jnp
    n = targets.shape[0]
    slab = min(slab, n_pad)
    assert n_pad % slab == 0, (n_pad, slab)
    fill = _expand_codes_jit(L, slab)
    buf = jnp.full((CODE_ROWS, n_pad), PAD_CODE, jnp.int8)
    for t_lo in range(0, n, slab):
        t_hi = min(n, t_lo + slab)
        lo_h, hi_h = split_words(targets[t_lo:t_hi])
        if t_hi - t_lo < slab:
            pad = slab - (t_hi - t_lo)
            lo_h = np.pad(lo_h, (0, pad))
            hi_h = np.pad(hi_h, (0, pad))
        buf = fill(buf, jax.device_put(lo_h), jax.device_put(hi_h),
                   jnp.int32(t_lo), jnp.int32(t_hi - t_lo))
    return buf


class DeviceScanner:
    """Holds the database on device (plane-major codes) and scans guide
    batches against it.

    When the code planes exceed the device-memory budget (mm=5-scale
    databases, genomes beyond one card, or a shared card), the scanner
    streams the database through device memory in fixed-size target slabs instead of holding it resident:
    ascending slabs x guide blocks, so per-guide hits still arrive in global
    target order and all slabs share one compiled executable.

    COST CONTRACT of the streaming mode: every scan() call re-uploads the
    whole database (the slabs cannot persist — they cycle through the same
    device memory), so an N-scan workload pays N uploads over the host link. For a
    max_mismatch SWEEP specifically, do NOT call scan() per mm value: one
    scan at the LARGEST mm yields every lower-mm hit with its exact
    mismatch count in the mm column — filter host-side (an mm<=k hit set is
    a superset-filter of the mm<=k-1 set, reference
    traversal/LinearTraversal.scala:82-97 prunes the same way). Resident
    mode has no such concern: repeat scans reuse the uploaded planes."""

    def __init__(self, db: Database, use_pallas: Optional[bool] = None,
                 chunk: Optional[int] = None, cap: int = DEFAULT_CAP,
                 trip_cap: int = TRIPLET_CAP,
                 hbm_budget: Optional[int] = None,
                 time_init: bool = False):
        import time
        import jax
        enable_compilation_cache()
        self.trip_cap = trip_cap
        self.db = db
        self.L = db.pack.total_scan_length
        self.n_act = len(db.pack.comparison_mask_positions())
        if use_pallas is None:
            use_pallas = use_stage1_kernel(default_platform())
        chunk = scan_chunk(use_pallas, chunk)
        self.chunk = chunk
        # chunk may shrink when col_cap hits its ceiling (see _scan_blocks);
        # it must remain a T_TILE multiple that divides the padded width
        self._min_chunk = min_scan_chunk(use_pallas)
        self.cap = cap
        # caps escalate stickily PER max_mismatch: an mm=5 scan needs ~10x
        # the column/triplet caps of mm=4, and leaving them escalated would
        # make every later mm=4 scan pay mm=5-sized compaction domains and
        # fetch buffers
        self._cap0, self._trip0 = cap, trip_cap
        self._caps = {}
        n = db.num_targets
        self.n = n
        n_pad = max(chunk, int(np.ceil(max(n, 1) / chunk)) * chunk)
        if hbm_budget is None:
            hbm_budget = hbm_budget_bytes(
                scan_working_set_bytes(chunk, use_pallas))
        self.init_timings = {}
        # 33 B per target: the code planes and the stage-1 hit byte
        if (CODE_ROWS + 1) * n_pad <= hbm_budget:
            t0 = time.time()
            if os.environ.get("FLASHFRY_TPU_HOST_CODES"):
                codes_host = plane_codes(db.targets, self.L, n_pad)
                t1 = time.time()
                self.codes = jax.device_put(codes_host)
                if time_init:
                    self.codes.block_until_ready()
                    self.init_timings["plane_codes_s"] = round(t1 - t0, 3)
                    self.init_timings["hbm_upload_s"] = round(time.time() - t1, 3)
            else:
                # stream packed words (8 B/target) and expand to plane codes
                # on device: 4x less upload and no host-side 32-byte plane
                # build
                self.codes = device_plane_codes(db.targets, self.L, n_pad,
                                                self.chunk)
                if time_init:
                    self.codes.block_until_ready()
                    self.init_timings["codes_upload_expand_s"] = round(
                        time.time() - t0, 3)
            self.slab_n = n_pad
        else:
            self.codes = None  # streaming: slabs uploaded per scan
            per_slab = max(hbm_budget // (2 * CODE_ROWS), chunk)  # double-buffer room
            self.slab_n = max(chunk, (per_slab // chunk) * chunk)
        self.use_pallas = use_pallas
        # the kernel runs interpreted only where the scanner's device is the
        # CPU (tests); on the GPU it is always the compiled kernel
        self.interpret = use_pallas and default_platform() == "cpu"

    def scan(self, guide_longs: np.ndarray, max_mismatch: int,
             bin_mask: Optional[np.ndarray] = None,
             stats=None) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (target_idx, guide_idx, mm) batches; within each guide, hits
        arrive in global target order (the ordering the overflow cap needs).

        The dense device scan returns exactly the hits FlashFry's pruned
        traversal finds (bin pruning is lossless), so bin_mask is not needed
        for correctness; it is accepted for interface parity and ignored.

        Guides run in fixed-size blocks (128 up to max_guide_block(),
        default 2048 rows) so every device executable has one of a handful
        of static shapes — compiled once, persistently cached, reused for
        any guide count.
        """
        import jax
        g_all = np.asarray(guide_longs, dtype=np.uint64)
        n_guides = g_all.shape[0]
        # Larger blocks halve the per-chunk fixed costs (column search,
        # gathers, emit) per guide but grow the stage-2 (col_cap, G)
        # domain; 2048 is the default and FLASHFRY_TPU_MAX_BLOCK
        # (max_guide_block, tools/ab_block.py) re-probes it.
        max_block = max_guide_block()
        block = 128
        while block < n_guides and block < max_block:
            block *= 2
        blocks = interleaved_blocks(n_guides, block)
        key = int(max_mismatch)
        # live caps are LOCAL to this scan generator (a mutable [cap,
        # trip_cap] threaded through _scan_blocks/_dispatch_block), so two
        # interleaved scan generators at different max_mismatch on one
        # scanner cannot cross-contaminate each other's sticky caps; each
        # persists its own escalations under its own mm key on exit.
        caps = list(self._caps.get(key, (self._cap0, self._trip0)))
        try:
            if self.codes is not None:
                yield from self._scan_blocks(g_all, blocks, max_mismatch,
                                             stats, block, self.codes, 0,
                                             self.n, caps)
                return
            # streaming: ascending slabs outer, preserving per-guide order
            for t_lo in range(0, self.n, self.slab_n):
                t_hi = min(self.n, t_lo + self.slab_n)
                codes_d = device_plane_codes(
                    self.db.targets[t_lo:t_hi], self.L, self.slab_n,
                    self.chunk)
                for t_idx, g_idx, mm in self._scan_blocks(
                        g_all, blocks, max_mismatch,
                        stats if t_lo == 0 else None, block,
                        codes_d, t_lo, t_hi - t_lo, caps):
                    yield t_idx + t_lo, g_idx, mm
                del codes_d
        finally:
            self._caps[key] = (caps[0], caps[1])

    FETCH_SLICE_MIN = 1 << 19  # buffers larger than this fetch count-first

    def _fetch_triplets(self, buf_d, trip_cap):
        """Fetch one fused-scan buffer -> (t_idx, g_idx, mm, count,
        overflow).

        Small buffers come back in ONE fetch. Large buffers — escalated
        triplet caps reach millions of slots at 8 B each — fetch the 2-word
        header first, then only a 64k-bucketed slice covering the real triplet count, so an
        over-provisioned cap costs bandwidth proportional to the HITS, not
        the cap. Bucketing keeps the slice executable count bounded (each
        static slice shape compiles once, persistently cached)."""
        import jax
        width = buf_d.shape[1]
        if width - 2 <= self.FETCH_SLICE_MIN:
            buf = np.asarray(buf_d)  # ONE fetch
            return parse_trip_buffer(buf)
        head = np.asarray(buf_d[0, width - 2:])
        count, overflow = int(head[0]), int(head[1])
        n = 0 if (overflow or count > trip_cap) else count
        if n == 0:
            z = np.zeros(0, np.int64)
            return z, z, z.astype(np.int8), count, overflow
        bucket = min(width - 2, -(-n // (1 << 16)) * (1 << 16))
        body = np.asarray(
            jax.lax.dynamic_slice_in_dim(buf_d, 0, bucket, axis=1))
        packed = body[1, :n]
        return (body[0, :n].astype(np.int64), (packed >> 8).astype(np.int64),
                (packed & 0xFF).astype(np.int8), count, overflow)

    def _dispatch_block(self, guide_longs: np.ndarray, max_mismatch: int,
                        stats, pad_to: int, codes, caps):
        """Launch one fixed-shape guide block asynchronously; returns
        (device buffer, caps used). jax dispatch is async, so successive
        blocks queue on the device and device->host fetches of earlier
        buffers overlap later blocks' compute on many-block (10^4-10^5
        guide) scans."""
        import jax
        guide_oh, n_active, G = guide_onehot_matrix(guide_longs, self.db.pack,
                                                    pad_to=pad_to)
        n_chunks = codes.shape[1] // self.chunk
        if stats is not None and G:
            # all_comparisons (the FlashFry-equivalent pruned count) is set by
            # the caller (engine.discover via engine.pruned_comparisons); the
            # scanner only tracks the raw work it performs.
            stats.all_targets += self.n
            stats.all_targets_and_positions += int(self.db.pos_offsets[-1])
            stats.dense_comparisons += self.n * G
        fused = _fused_scan_jit(self.L, self.n_act, max_mismatch,
                                self.chunk, guide_oh.shape[0], n_chunks,
                                caps[0], caps[1], self.use_pallas,
                                STAGE2_INT8, TRIP_TILE, self.interpret)
        buf_d = fused(codes, jax.device_put(guide_oh), jax.device_put(n_active))
        return buf_d, caps[0], caps[1]

    def _scan_blocks(self, g_all: np.ndarray, blocks, max_mismatch: int,
                     stats, pad_to: int, codes, t_base: int,
                     n_valid: int, caps) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """All guide blocks (index arrays) against one resident code array,
        pipelined PIPELINE_DEPTH deep; yields hits with global guide indices
        (target-major per guide). On cap overflow, caps escalate STICKILY up
        to COL_CAP_MAX/TRIP_CAP_MAX — the failed block retries synchronously
        and every later block dispatches straight at the size that worked
        (each size compiles once, persistently cached). A column overflow at
        COL_CAP_MAX shrinks the CHUNK instead (columns per chunk scale with
        chunk; the stage-2 (col_cap, G) domain must stay bounded); after
        MAX_RETRIES, the block falls back to the exact host scan."""
        from collections import deque
        pending = deque()
        it = iter(blocks)

        def fill():
            while len(pending) < PIPELINE_DEPTH:
                idx = next(it, None)
                if idx is None:
                    return
                buf_d, cap, trip_cap = self._dispatch_block(
                    g_all[idx], max_mismatch, stats, pad_to, codes, caps)
                pending.append((idx, buf_d, cap, trip_cap))

        def escalate(overflow, count, used_col, used_trip):
            """Grow only the cap that tripped, and ONLY if this dispatch
            actually used the current value — the pipeline keeps
            PIPELINE_DEPTH blocks in flight at the caps of their dispatch
            time, and without this guard three stale-cap failures escalate
            three times in a row (col 4096 -> 32768 in one burst, putting
            every later block on a 4x-too-large stage-2 domain)."""
            import logging
            if (overflow & 1) and caps[0] == used_col:
                if caps[0] < COL_CAP_MAX:
                    # x2 steps: stage-2 cost is ~linear in col_cap, so a
                    # finer fit repays the one extra retry on the first scan
                    caps[0] = min(caps[0] * 2, COL_CAP_MAX)
                elif self.chunk > self._min_chunk:
                    # the new chunk must DIVIDE the current one (any
                    # divisor also divides the padded code width, so the
                    # chunk loop still covers every column) and stay a
                    # _min_chunk (T_TILE) multiple for the kernel's tile
                    # contract; prefer /4, then /2, then the tile floor
                    for d in (4, 2):
                        if self.chunk % (d * self._min_chunk) == 0:
                            self.chunk //= d
                            break
                    else:
                        if self.chunk % self._min_chunk == 0:
                            self.chunk = self._min_chunk
                    logging.getLogger(__name__).info(
                        "col cap at ceiling %d: shrinking chunk to %d",
                        caps[0], self.chunk)
            if ((overflow & 2) or count > used_trip) and caps[1] == used_trip:
                # `count` is the TRUE triplet total even when the buffer
                # overflowed (per-chunk counts accumulate unclamped), so
                # jump straight to a power-of-two covering it (+25%
                # headroom) instead of x4 stepping — every intermediate cap
                # is a fresh executable to compile. count undercounts only
                # if columns also overflowed; the next retry re-escalates.
                want = max(caps[1] * 4, 1 << int(count + count // 4
                                                 ).bit_length())
                caps[1] = min(want, TRIP_CAP_MAX)

        fill()
        while pending:
            idx, buf_d, used_col, trip_cap = pending.popleft()
            for _attempt in range(1 + MAX_RETRIES):
                t_idx, g_idx, mm, count, overflow = self._fetch_triplets(
                    buf_d, trip_cap)
                if not overflow and count <= trip_cap:
                    if count:
                        yield t_idx, idx[g_idx], mm
                    break
                escalate(overflow, count, used_col, trip_cap)
                if _attempt == MAX_RETRIES:
                    continue  # out of retries: fall through to the host scan
                buf_d, used_col, trip_cap = self._dispatch_block(
                    g_all[idx], max_mismatch, None, pad_to, codes, caps)
            else:
                import logging
                logging.getLogger(__name__).warning(
                    "device scan caps exhausted after %d retries for a "
                    "%d-guide block; running the exact host fallback (slow)",
                    MAX_RETRIES, idx.shape[0])
                for t_idx, g_idx, mm in self._host_scan(
                        g_all[idx], max_mismatch,
                        t_base=t_base, n_valid=n_valid):
                    yield t_idx, idx[g_idx], mm
            fill()

    def _host_scan(self, guide_longs, max_mismatch,
                   chunk: int = 1 << 20, t_base: int = 0,
                   n_valid: Optional[int] = None):
        """Exact vectorized host fallback (target-major order, slab-local
        indices relative to t_base)."""
        from ..bitcoding import BitEncoding
        enc = BitEncoding(self.db.pack)
        g = np.asarray(guide_longs, dtype=np.uint64)
        n = self.n - t_base if n_valid is None else n_valid
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            mm = enc.mismatches_cross(
                self.db.targets[t_base + lo:t_base + hi], g)
            t_idx, g_idx = np.nonzero(mm <= max_mismatch)
            if t_idx.size:
                yield t_idx + lo, g_idx, mm[t_idx, g_idx].astype(np.int8)


def scan_database_jax(db: Database, guide_longs: np.ndarray, max_mismatch: int,
                      stats, bin_mask: Optional[np.ndarray]):
    """Entry point used by the engine: one-shot scanner."""
    scanner = DeviceScanner(db)
    return scanner.scan(guide_longs, max_mismatch, bin_mask, stats)
