"""Fused stage-1 kernel for the off-target scan, written for Hopper GPUs.

Pallas through Triton (``backend="triton"``). Each program owns a tile of
T_TILE targets: it loads that tile's (32, T) int8 plane codes, builds the
(128, T) one-hot in registers, then walks the guide matrix G_TILE rows at a
time. Every step is an int8 ``pl.dot`` with int32 accumulation whose
(G_TILE, T) match tile is reduced at once to a running per-target max, so
the (G, N) match matrix never reaches device memory: a program reads
33 B per target plus the guide rows (served from L2) and writes 1 B.

Per-guide thresholds are unnecessary: all real guides of an enzyme share
|active| (the PAM-masked base count), so "mismatches <= k" is the scalar
compare "max_g matches >= |active| - k", fixed at trace time. Guide padding
rows are all-zero (0 matches) and the threshold is clamped >= 1, so padding
never fires; padding target columns hold PAD_CODE, whose one-hot is
all-zero.

Blocks run in parallel in no order, so nothing carries from one program to
the next; the guide loop inside the program takes the place of a sequential
grid axis.

This replaces the reference's scalar inner loop
(reference/binary/blocks/BlockManager.scala:225-253) and realizes the
data-parallel formulation its commented-out GPU kernel sketched
(java/bitcoding/GPUBitBlockCompare.java).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Tile shape: the fastest of a sweep over T_TILE 128-512, G_TILE 64/128,
# 4/8 warps and 2/3 pipeline stages on an H100 80GB HBM3 (400 W limit);
# PERF.md has the numbers. A one-hot built in registers per dot (rather
# than four K=32 dots, one per base) was faster at every shape.
T_TILE = 128    # targets per program (power of two; the chunk is a multiple)
G_TILE = 128    # guide rows per inner step
NUM_WARPS = 4   # one warpgroup
NUM_STAGES = 3  # software-pipelining depth of the guide loop
OH_ROWS = 128   # one-hot width: 4*L <= 96 for all enzymes, padded to 128
CODE_ROWS = 32  # plane-major code rows (L <= 24)


def _stage1_kernel(thr: int, n_steps: int, code_ref, guide_ref, out_ref):
    # One-hot in BLOCK layout: row b*32+i = (base i == b). Rows with i >= L
    # hold code 0, so their b=0 rows are all-ones — harmless, the matching
    # guide columns are zero (guide_block_layout).
    codes = code_ref[...].astype(jnp.int32)                       # (32, T)
    t = codes.shape[1]
    b = jax.lax.broadcasted_iota(jnp.int32, (4, CODE_ROWS, t), 0)
    t_oh = (codes[None] == b).astype(jnp.int8).reshape(OH_ROWS, t)

    def step(k, best):
        g = guide_ref[pl.ds(k * G_TILE, G_TILE), :]               # (Gt, 128)
        m = pl.dot(g, t_oh)                                       # (Gt, T) i32
        return jnp.maximum(best, jnp.max(m, axis=0))

    best = jax.lax.fori_loop(0, n_steps, step, jnp.zeros((t,), jnp.int32))
    out_ref[...] = (best >= thr).astype(jnp.int8)


def guide_block_layout(guide_oh, L: int):
    """(G, 4L) one-hot (column 4i+b) -> (G, 128) int8 in the kernel's block
    layout (column b*32+i). jnp ops so it can run inside the fused jit."""
    G = guide_oh.shape[0]
    g = guide_oh.reshape(G, L, 4).transpose(0, 2, 1)          # (G, 4, L)
    g = jnp.pad(g, ((0, 0), (0, 0), (0, CODE_ROWS - L)))
    return g.reshape(G, OH_ROWS).astype(jnp.int8)


@functools.lru_cache(maxsize=8)
def stage1_pallas(n_active: int, max_mm: int, n_cols: int, g_rows: int,
                  interpret: bool = False):
    """Returns (codes (32, n_cols) int8, guide_i8 (g_rows, 128) int8) ->
    (n_cols,) bool: does any guide row reach the threshold at each target.
    n_cols must be a T_TILE multiple and g_rows a G_TILE multiple.
    interpret=True runs the same kernel on the CPU (tests)."""
    if n_cols % T_TILE or g_rows % G_TILE:
        raise ValueError("stage1_pallas needs n_cols %% %d == 0 and "
                         "g_rows %% %d == 0, got %d, %d"
                         % (T_TILE, G_TILE, n_cols, g_rows))
    thr = max(n_active - max_mm, 1)
    kernel = functools.partial(_stage1_kernel, thr, g_rows // G_TILE)
    call = pl.pallas_call(
        kernel,
        grid=(n_cols // T_TILE,),
        in_specs=[
            pl.BlockSpec((CODE_ROWS, T_TILE), lambda t: (0, t)),
            pl.BlockSpec((g_rows, OH_ROWS), lambda t: (0, 0)),
        ],
        out_specs=pl.BlockSpec((T_TILE,), lambda t: (t,)),
        out_shape=jax.ShapeDtypeStruct((n_cols,), jnp.int8),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                    num_stages=NUM_STAGES),
        interpret=interpret,
        name="flashfry_stage1",
        cost_estimate=pl.CostEstimate(
            flops=2 * n_cols * OH_ROWS * g_rows,
            bytes_accessed=n_cols * (CODE_ROWS + 1) + OH_ROWS * g_rows,
            transcendentals=0,
        ),
    )

    def f(codes, guide_i8):
        return call(codes, guide_i8) > 0

    return f
