"""Jit-safe compensated arithmetic (ops/dsjit.py).

The whole point of the module is surviving XLA compilation (FMA
contraction, algebraic simplification), so every accuracy assertion here
runs UNDER jax.jit on f32 inputs and is verified against f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riskaversetrajopt_tpu.ops import dsjit as ds


def _rand(key, shape, scale=1.0):
    return (scale * jax.random.normal(key, shape)).astype(jnp.float32)


def test_mask_split_exact():
    x = _rand(jax.random.PRNGKey(0), (1024,), scale=1e3)
    hi, lo = jax.jit(ds.mask_split)(x)
    # exact decomposition
    np.testing.assert_array_equal(
        np.asarray(hi, np.float64) + np.asarray(lo, np.float64),
        np.asarray(x, np.float64),
    )
    # hi fits in 12 significant bits: hi * hi is exact in f32
    h64 = np.asarray(hi, np.float64)
    np.testing.assert_array_equal(
        np.asarray(hi * hi, np.float64), h64 * h64
    )


def test_two_sum_exact_under_jit():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    a = _rand(k1, (4096,), scale=1.0)
    b = _rand(k2, (4096,), scale=1e-5)
    s, e = jax.jit(ds.two_sum)(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_two_prod_exact_under_jit():
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    a = _rand(k1, (4096,), scale=37.0)
    b = _rand(k2, (4096,), scale=0.61)
    p, e = jax.jit(ds.two_prod)(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    # f32 two_prod is exact: the f64 product of two f32 is representable
    np.testing.assert_array_equal(got, exact)


def test_ds_sum_compensated():
    # ill-conditioned sum: big + many smalls that a plain f32 sum loses
    x = np.concatenate([
        [1e8], np.full(4096, 0.1, np.float32), [-1e8]
    ]).astype(np.float32)
    h, lo = jax.jit(lambda v: ds.sum1_ds(v))(jnp.asarray(x))
    exact = np.sum(np.asarray(x, np.float64))
    got = float(np.asarray(h, np.float64) + np.asarray(lo, np.float64))
    assert abs(got - exact) / abs(exact) < 1e-6
    # plain f32 sum is far worse on this input
    plain = float(jnp.sum(jnp.asarray(x)))
    assert abs(plain - exact) > 100 * abs(got - exact)


def test_dot2_vs_f64():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    A = _rand(k1, (64, 200), scale=5.0)
    x = _rand(k2, (200,), scale=2.0)
    h, lo = jax.jit(ds.dot2)(A, x)
    exact = np.asarray(A, np.float64) @ np.asarray(x, np.float64)
    got = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    err = np.max(np.abs(got - exact)) / np.max(np.abs(exact))
    assert err < 1e-12, err


def test_contractions_vs_f64():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
    M, K, n = 37, 11, 23
    G = _rand(k1, (M, K, n), scale=3.0)
    x = _rand(k2, (n,), scale=1.5)
    w = _rand(k3, (M, K), scale=0.7)

    h, lo = jax.jit(lambda G, x: ds.contract_mkn_n(G, x, jnp.zeros_like(x)))(
        G, x
    )
    exact = np.einsum(
        "mkn,n->mk", np.asarray(G, np.float64), np.asarray(x, np.float64)
    )
    got = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-12

    h2, lo2 = jax.jit(
        lambda G, w: ds.contract_mkn_mk(G, w, jnp.zeros_like(w))
    )(G, w)
    exact2 = np.einsum(
        "mkn,mk->n", np.asarray(G, np.float64), np.asarray(w, np.float64)
    )
    got2 = np.asarray(h2, np.float64) + np.asarray(lo2, np.float64)
    assert np.max(np.abs(got2 - exact2)) / np.max(np.abs(exact2)) < 1e-12


def test_contractions_chunked_vs_f64():
    """Chunked sample-axis contractions (the fusion-budget workaround,
    ds.contract_*(chunk=...)) keep full compensated accuracy, including a
    sample count that is not a multiple of the chunk (zero padding)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    M, K, n = 37, 11, 23
    G = _rand(k1, (M, K, n), scale=3.0)
    x = _rand(k2, (n,), scale=1.5)
    w = _rand(k3, (M, K), scale=0.7)

    h, lo = jax.jit(
        lambda G, x: ds.contract_mkn_n(G, x, jnp.zeros_like(x), chunk=8)
    )(G, x)
    exact = np.einsum(
        "mkn,n->mk", np.asarray(G, np.float64), np.asarray(x, np.float64)
    )
    got = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 1e-12

    h2, lo2 = jax.jit(
        lambda G, w: ds.contract_mkn_mk(G, w, jnp.zeros_like(w), chunk=8)
    )(G, w)
    exact2 = np.einsum(
        "mkn,mk->n", np.asarray(G, np.float64), np.asarray(w, np.float64)
    )
    got2 = np.asarray(h2, np.float64) + np.asarray(lo2, np.float64)
    assert np.max(np.abs(got2 - exact2)) / np.max(np.abs(exact2)) < 1e-12


def test_ds_scale_and_mul():
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    a = _rand(k1, (512,), scale=11.0)
    s = _rand(k2, (512,), scale=0.03)
    h, lo = jax.jit(lambda a, s: ds.ds_scale(a, jnp.zeros_like(a), s))(a, s)
    exact = np.asarray(a, np.float64) * np.asarray(s, np.float64)
    got = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_array_equal(got, exact)  # f32 two_prod is exact


def test_f64_path():
    # dtype-generic: in f64 the same code gives ~double-double accuracy
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=2048) * 1e6)
    assert x.dtype == jnp.float64
    h, lo = jax.jit(lambda v: ds.sum1_ds(v))(x)
    # cross-check against math.fsum (exact)
    import math

    exact = math.fsum(np.asarray(x).tolist())
    assert abs((float(h) + float(lo)) - exact) <= 1e-9 * abs(exact) + 1e-12
