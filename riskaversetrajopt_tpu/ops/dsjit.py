"""Jit-safe compensated (double-single) arithmetic for the f32-only path.

`ops/ds.py` provides Dekker-style error-free transforms but is EAGER-ONLY:
XLA contracts mul-followed-by-add chains into FMA, which changes the
rounding its multiplicative splitting depends on. This module provides the
jittable counterpart, built so that FMA contraction cannot change any
value:

- operands are split by MANTISSA BIT-MASKING (bitcast + AND), which is
  exact by construction — no rounding behavior is relied upon;
- for binary32 the split keeps 12 significant bits, so EVERY partial
  product of split operands has <= 24 significant bits and is exactly
  representable: a fused multiply-add of exact products is identical to
  the unfused sequence, making the error computation FMA-immune;
- `two_sum` uses only adds/subs, which XLA never fuses; the
  optimization barriers guard against algebraic simplification of the
  (a + b) - a patterns.

Intended use: the iterative-refinement outer loop of the structured SAA
QP solve (ops/qp_refine.py) — residuals and shifted problem data computed
to ~1e-12 relative in f32-only arithmetic, while the ADMM hot loop stays
plain f32 (SURVEY.md §7.3.1-2: the reference gets this accuracy for free
from CPU x64, e.g. OSQP at eps 1e-8 in car/driving_gaussian.py:27).

All functions are dtype-generic (f64 gives the classic double-double-style
split with one rounded low-order product, ~1e-31 class); the working pair
is (hi, lo) with hi = fl(hi + lo).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_ob = lax.optimization_barrier

# mask away the low mantissa bits: binary32 keeps 12 significant bits
# (11 stored), so 12x12-bit partial products (24 bits) are exact; binary64
# keeps 27 (Dekker's split point — the lo*lo product takes one rounding)
_MASKS = {
    jnp.dtype(jnp.float32): (jnp.int32, 0xFFFFF000 - 0x100000000),
    jnp.dtype(jnp.float64): (jnp.int64, -0x4000000),  # 0xFFFFFFFFFC000000
}


def mask_split(a):
    """Exact a = hi + lo with a truncated-mantissa hi (FMA-immune)."""
    ity, mask = _MASKS[jnp.dtype(a.dtype)]
    bits = lax.bitcast_convert_type(a, ity)
    hi = lax.bitcast_convert_type(
        jnp.bitwise_and(bits, jnp.asarray(mask, ity)), a.dtype
    )
    return hi, a - hi  # a - hi is exact: lo is a's truncated tail


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; adds only, safe under jit)."""
    s = _ob(a + b)
    bb = _ob(s - a)
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (renormalization)."""
    s = _ob(a + b)
    return s, b - (s - a)


def two_prod(a, b):
    """a * b = p + e; all partial products exact via mask_split."""
    p = _ob(a * b)
    a1, a2 = mask_split(a)
    b1, b2 = mask_split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def ds_add(h1, l1, h2, l2):
    """(h1, l1) + (h2, l2), renormalized."""
    s, e = two_sum(h1, h2)
    return quick_two_sum(s, e + l1 + l2)


def ds_neg(h, l):
    return -h, -l


def ds_scale(h, l, s):
    """(h, l) * s for an exact scalar/array s."""
    p, e = two_prod(h, s)
    return quick_two_sum(p, e + l * s)


def ds_mul(h1, l1, h2, l2):
    """(h1, l1) * (h2, l2) to first order in the low parts."""
    p, e = two_prod(h1, h2)
    return quick_two_sum(p, e + h1 * l2 + l1 * h2)


def ds_div(h, l, d):
    """(h, l) / d for an exact (array/scalar) divisor d.

    One Newton correction of the f32 quotient: q0 = fl(h/d); the residual
    h + l - q0*d is formed exactly via two_prod (h - p is exact by
    Sterbenz' lemma since p ~ h), giving ~eps^2-relative accuracy."""
    q0 = _ob(h / d)
    p, e = two_prod(q0, d)
    r = ((h - p) - e) + l
    return quick_two_sum(q0, r / d)


def ds_round(h, l):
    """Best single-float representation of (h, l)."""
    return h + l


def ds_where(c, h1, l1, h2, l2):
    return jnp.where(c, h1, h2), jnp.where(c, l1, l2)


def _pad_pow2(h, l, axis):
    n = h.shape[axis]
    p = 1
    while p < n:
        p *= 2
    if p == n:
        return h, l
    pad = [(0, 0)] * h.ndim
    pad[axis] = (0, p - n)
    return jnp.pad(h, pad), jnp.pad(l, pad)


def ds_sum(h, l, axis):
    """Compensated reduction of an array of (hi, lo) pairs along `axis`
    by pairwise halving with ds_add — fully vectorized, error ~log2(n)
    renormalization roundings (eps^2-class)."""
    if isinstance(axis, (tuple, list)):
        for ax in sorted(axis, reverse=True):
            h, l = ds_sum(h, l, ax)
        return h, l
    h, l = _pad_pow2(h, l, axis)
    while h.shape[axis] > 1:
        half = h.shape[axis] // 2
        h1 = lax.slice_in_dim(h, 0, half, axis=axis)
        h2 = lax.slice_in_dim(h, half, 2 * half, axis=axis)
        l1 = lax.slice_in_dim(l, 0, half, axis=axis)
        l2 = lax.slice_in_dim(l, half, 2 * half, axis=axis)
        h, l = ds_add(h1, l1, h2, l2)
    return jnp.squeeze(h, axis), jnp.squeeze(l, axis)


def sum1_ds(x, axis=None):
    """Compensated sum of a plain array."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return ds_sum(x, jnp.zeros_like(x), axis)


def dot2(A, x):
    """Compensated A @ x for a dense (m, n) A — Ogita-Rump-Oishi Dot2
    accuracy, vectorized: exact elementwise products, pairwise ds
    reduction. Returns an (m,) ds pair."""
    p, e = two_prod(A, x[None, :])
    return ds_sum(p, e, axis=1)


def rdot2(A, w):
    """Compensated A.T @ w for dense (m, n) A and (m,) w."""
    p, e = two_prod(A, w[:, None])
    return ds_sum(p, e, axis=0)


def _pad_rows(x, mult):
    """Pad the leading axis to a multiple of `mult` (zeros)."""
    r = (-x.shape[0]) % mult
    if r == 0:
        return x
    pad = [(0, r)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def contract_mkn_n(G, x_h, x_l, chunk=None):
    """Compensated einsum('mkn,n->mk', G, x) with a ds vector x.

    `chunk`: process the sample axis in chunks of this size (lax.map).
    The unchunked form materializes ~4 full (M, K, n) intermediates plus
    the pairwise-reduction ladder; past M ~ 512 (drone shapes) that
    working set stopped fitting the fusion budget and the sweep fell off
    a ~10x cliff on the accelerator this was first built for (not
    measured on the H100). Chunking bounds the live set; cross-chunk order
    is unchanged (the reduction is over the minor axes only)."""
    if chunk is None or G.shape[0] <= chunk:
        p, e = two_prod(G, x_h[None, None, :])
        e = e + G * x_l[None, None, :]
        return ds_sum(p, e, axis=2)
    M0, K = G.shape[0], G.shape[1]
    Gp = _pad_rows(G, chunk)
    C = Gp.shape[0] // chunk
    Gc = Gp.reshape(C, chunk, *G.shape[1:])

    def body(g):
        p, e = two_prod(g, x_h[None, None, :])
        e = e + g * x_l[None, None, :]
        return ds_sum(p, e, axis=2)

    h, lo = lax.map(body, Gc)
    return (h.reshape(C * chunk, K)[:M0], lo.reshape(C * chunk, K)[:M0])


def contract_mkn_mk(G, w_h, w_l, chunk=None):
    """Compensated einsum('mkn,mk->n', G, w) with ds weights w.

    `chunk` as in contract_mkn_n; the per-chunk (n,) partials are
    ds-accumulated across chunks (one extra eps^2 rounding per chunk)."""
    if chunk is None or G.shape[0] <= chunk:
        p, e = two_prod(G, w_h[:, :, None])
        e = e + G * w_l[:, :, None]
        return ds_sum(p, e, axis=(0, 1))
    n = G.shape[2]
    Gp = _pad_rows(G, chunk)
    C = Gp.shape[0] // chunk
    Gc = Gp.reshape(C, chunk, *G.shape[1:])
    wh = _pad_rows(w_h, chunk).reshape(C, chunk, -1)
    wl = _pad_rows(w_l, chunk).reshape(C, chunk, -1)

    def body(carry, xs):
        h0, l0 = carry
        g, wch, wcl = xs
        p, e = two_prod(g, wch[:, :, None])
        e = e + g * wcl[:, :, None]
        h, lo = ds_sum(p, e, axis=(0, 1))
        return ds_add(h0, l0, h, lo), None

    (h, lo), _ = lax.scan(
        body,
        (jnp.zeros(n, G.dtype), jnp.zeros(n, G.dtype)),
        (Gc, wh, wl),
    )
    return h, lo
