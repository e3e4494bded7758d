"""Sweep _packed_nonzero's tile width T on the accelerator for the two shapes
the fused scan uses: (8.4M mask, cap 4096) and (cap*G=4.2M mask, cap 16384)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from flashfry_tpu.ops import scan as S


def packed_nonzero_T(mask, size, T):
    n_el = mask.shape[0]
    if n_el % T or n_el <= 2 * T:
        cnt = jnp.cumsum(mask.astype(jnp.int32))
        idx = jnp.searchsorted(cnt, jnp.arange(1, size + 1, dtype=jnp.int32),
                               side="left")
        return jnp.minimum(idx, n_el - 1).astype(jnp.int32), cnt[-1]
    nt = n_el // T
    m2 = mask.reshape(nt, T)
    tcnt = m2.sum(axis=1, dtype=jnp.int32)
    tile_cum = jnp.cumsum(tcnt)
    n = tile_cum[-1]
    q = jnp.arange(1, size + 1, dtype=jnp.int32)
    qt = jnp.searchsorted(tile_cum, q, side="left")
    qt = jnp.minimum(qt, nt - 1)
    r = q - (tile_cum[qt] - tcnt[qt])
    rows = m2[qt].astype(jnp.int32)
    lc = jnp.cumsum(rows, axis=1)
    pos = jnp.sum(lc < r[:, None], axis=1)
    idx = qt * T + pos
    return jnp.minimum(idx, n_el - 1).astype(jnp.int32), n


def bench(name, fn, first_arg, rest, K=16):
    @jax.jit
    def f(a0, *r):
        def body(i, acc):
            return acc + fn(a0 ^ i.astype(a0.dtype), *r).sum().astype(jnp.int32)
        return jax.lax.fori_loop(0, K, body, jnp.int32(0))
    np.asarray(f(first_arg, *rest))
    t0 = time.time()
    iters = 3
    for _ in range(iters):
        np.asarray(f(first_arg, *rest))
    dt = (time.time() - t0) / iters / K
    print("%-40s %.4fs" % (name, dt), flush=True)


def main():
    rng = np.random.default_rng(0)
    for n_el, cap, dens in ((1 << 23, 1 << 12, 4e-4), ((1 << 12) * 1024, 1 << 14, 5e-3)):
        m = (rng.random(n_el) < dens)
        mask = jnp.asarray(m.astype(np.int8))
        for T in (128, 256, 512, 1024):
            def fn(mk, T=T, cap=cap):
                idx, n = packed_nonzero_T(mk.reshape(-1) > 0, cap, T)
                return idx[:1] + n
            bench("n=%d cap=%d T=%d" % (n_el, cap, T), fn, mask, ())


if __name__ == "__main__":
    main()
