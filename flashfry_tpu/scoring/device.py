"""Device-side mismatch-descriptor extraction for OT scoring.

The scoring layer's device backend (SURVEY §7.5 "scoring become vectorized
JAX over the collected off-target sets"): the chip does ALL the integer
work of off-target scoring — decode the packed 2-bit sequences, compare
each OT against its guide at the enzyme comparison-mask positions, and
compact the mismatch descriptors (position, guide base, OT base) plus the
PAM dinucleotide into TWO int32 words per OT — and the host turns
descriptors into scores with O(#mismatches) exact f64 table gathers
(scoring/otbatch.py). Device traffic is 12 B/OT up (packed words + guide
index) and 8 B/OT down.

Why not score on device outright: the formatted output contract needs the
exact last ulp of the oracle's sequential f64 product (javafmt), and
device-side f64 products have not been shown to reproduce it bit for bit.
Integer compare/compact is exact on any backend, so the split keeps byte
parity while moving the O(N·L) work onto the device.

Word layout (consumed by otbatch.unpack_descriptors):
  w0: d0|d1|d2 (9 bits each: pos<<4|g<<2|o, ascending position) |
      min(mmc,7) (3 bits @27) | overflow=mmc>6 (bit 30)
  w1: d3|d4|d5 | PAM dinucleotide code (4 bits @27)
"""

from __future__ import annotations

import functools

import numpy as np

from ..bitcoding import STRING_MASK

_BUCKET = 1 << 16  # pad N to 64k buckets: bounded executable count


@functools.lru_cache(maxsize=8)
def _desc_jit(L: int, act: tuple, n_pad: int):
    import jax
    import jax.numpy as jnp

    def kernel(lo, hi, gi, gcodes):
        """lo/hi (n_pad,) i32 packed sequence halves; gi (n_pad,) i32;
        gcodes (G, L) i8 guide base codes. -> (w0, w1) i32[n_pad]."""
        gsel = gcodes[gi].astype(jnp.int32)                  # (n_pad, L)
        w0 = jnp.zeros(n_pad, jnp.int32)
        w1 = jnp.zeros(n_pad, jnp.int32)
        c = jnp.zeros(n_pad, jnp.int32)
        for p in act:
            s = 2 * (L - 1 - p)  # bases never straddle the 32-bit split
            w = lo if s < 32 else hi
            o = jax.lax.shift_right_logical(w, s % 32) & 3
            g = gsel[:, p]
            m = (o != g)
            d = (p << 4) | (g << 2) | o
            in0 = m & (c < 3)
            in1 = m & (c >= 3) & (c < 6)
            # clamp shift amounts to the selected range: the unselected
            # lanes' shifts would otherwise exceed the int32 width
            # (XLA leaves oversized shifts undefined, and where() computes
            # both branches)
            sh0 = 9 * jnp.minimum(c, 2)
            sh1 = 9 * jnp.clip(c - 3, 0, 2)
            w0 = w0 | jnp.where(in0, d << sh0, 0)
            w1 = w1 | jnp.where(in1, d << sh1, 0)
            c = c + m.astype(jnp.int32)
        w0 = w0 | (jnp.minimum(c, 7) << 27) | ((c > 6).astype(jnp.int32) << 30)
        # PAM dinucleotide: positions L-2, L-1 live in the low word
        pam = ((jax.lax.shift_right_logical(lo, 2) & 3) << 2) | (lo & 3)
        w1 = w1 | (pam << 27)
        return w0, w1

    return jax.jit(kernel)


def extract_descriptors(flat: np.ndarray, gi: np.ndarray, glongs: np.ndarray,
                        L: int, act_pos: np.ndarray):
    """Run the descriptor kernel on the default jax device; returns host
    (w0, w1) int32[N]. act_pos must be the contiguous guide region
    0..act_n-1 (true for every cas9 pack: the comparison mask excludes
    exactly the 3 trailing PAM bases)."""
    act_pos = np.asarray(act_pos)
    assert (act_pos == np.arange(act_pos.shape[0])).all(), \
        "descriptor kernel assumes a contiguous leading active region"
    import jax
    from ..ops.scan import split_words
    n = int(flat.shape[0])
    n_pad = max(_BUCKET, -(-n // _BUCKET) * _BUCKET)
    lo, hi = split_words(flat)
    lo = np.pad(lo, (0, n_pad - n))
    hi = np.pad(hi, (0, n_pad - n))
    gi32 = np.pad(np.asarray(gi, dtype=np.int32), (0, n_pad - n))
    G = int(np.asarray(glongs).shape[0])
    seq = np.asarray(glongs, dtype=np.uint64) & STRING_MASK
    gcodes = np.empty((G, L), dtype=np.int8)
    for p in range(L):
        gcodes[:, p] = ((seq >> np.uint64(2 * (L - 1 - p))) & np.uint64(3)
                        ).astype(np.int8)
    fn = _desc_jit(L, tuple(int(p) for p in act_pos), n_pad)
    w0_d, w1_d = fn(jax.device_put(lo), jax.device_put(hi),
                    jax.device_put(gi32), jax.device_put(gcodes))
    return np.asarray(w0_d)[:n], np.asarray(w1_d)[:n]
