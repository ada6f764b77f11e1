"""Modified Bessel function of the second kind K_v for real order, in JAX.

The reference evaluates the Matern kernel through R's `besselK`
(`1D Codes and Designs/1D Combined GP Public.R:348-352`). JAX has no K_v, so
this module implements the classical two-regime algorithm (Temme's series for
x <= 2, a Steed continued fraction for x > 2 — the scheme popularized by
Numerical Recipes' `bessik`) as fixed-trip-count, branchless element-wise JAX
code:

* both regimes are evaluated on clamped inputs and selected with `where`,
  so the computation is a static XLA graph (element-wise only, no data-dependent
  control flow);
* the order `v` must be a static Python float (it is a fixed model constant
  — e.g. nu=5 in the 1-D study), which lets the order-raising recurrence
  unroll at trace time;
* `bessel_kv` carries a custom JVP using dK_v/dx = (v/x) K_v - K_{v+1},
  so gradients for hyperparameter optimization are exact and cheap instead
  of differentiating through the series.

Accuracy: ~1e-12 relative in float64 (validated against scipy.special.kv in
tests/test_bessel.py), ~1e-5 in float32.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

# Taylor coefficients of 1/Gamma(1+z) = sum_k d_k z^k (A&S 6.1.34 shifted).
_D = (
    1.0,
    0.5772156649015329,
    -0.6558780715202538,
    -0.0420026350340952,
    0.1665386113822915,
    -0.0421977345555443,
    -0.0096219715278770,
    0.0072189432466630,
    -0.0011651675918591,
    -0.0002152416741149,
    0.0001280502823882,
    -0.0000201348547807,
    -0.0000012504934821,
    0.0000011330272320,
    -0.0000002056338417,
    0.0000000061160950,
    0.0000000050020075,
    -0.0000000011812746,
    0.0000000001043427,
    0.0000000000077823,
    -0.0000000000036968,
    0.0000000000005100,
)

_TEMME_ITERS = 24
_CF2_ITERS = 64


def _gamma_pair(mu: float):
    """Temme's Gamma1, Gamma2 and 1/Gamma(1 +- mu) for |mu| <= 1/2.

    Gamma1 = [1/Gamma(1-mu) - 1/Gamma(1+mu)] / (2 mu)  (cancellation-free
    via the odd part of the Taylor series), Gamma2 = the even part.
    """
    mu2 = mu * mu
    odd = _D[1::2]
    even = _D[0::2]
    # odd part: -(d1 + d3 mu^2 + d5 mu^4 + ...)
    gam1 = odd[-1]
    for coef in reversed(odd[:-1]):
        gam1 = coef + mu2 * gam1
    gam1 = -gam1
    # even part: d0 + d2 mu^2 + d4 mu^4 + ...
    gam2 = even[-1]
    for coef in reversed(even[:-1]):
        gam2 = coef + mu2 * gam2
    gampl = gam2 - mu * gam1  # 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1  # 1/Gamma(1-mu)
    return gam1, gam2, gampl, gammi


def _temme_pair(mu: float, x: jnp.ndarray):
    """(K_mu, K_{mu+1}) by Temme's series; accurate for 0 < x <= 2."""
    dtype = x.dtype
    gam1, gam2, gampl, gammi = _gamma_pair(mu)

    x2 = 0.5 * x
    d = -jnp.log(x2)
    e = mu * d
    # mu*pi/sin(mu*pi) == 1/sinc(mu); sinc handles mu=0.
    fact = jnp.asarray(1.0 / math.sin(math.pi * mu) * (math.pi * mu)
                       if mu != 0.0 else 1.0, dtype)
    small = jnp.abs(e) < 1e-12
    e_safe = jnp.where(small, 1.0, e)
    fact2 = jnp.where(small, 1.0 + e * e / 6.0, jnp.sinh(e_safe) / e_safe)
    ff = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d)
    summ = ff
    ee = jnp.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = jnp.ones_like(x)
    d2 = x2 * x2
    sum1 = p

    def body(i, carry):
        ff, p, q, c, summ, sum1 = carry
        fi = i.astype(dtype)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        summ = summ + c * ff
        sum1 = sum1 + c * (p - fi * ff)
        return ff, p, q, c, summ, sum1

    init = (ff, p, q, c, summ, sum1)
    _, _, _, _, summ, sum1 = jax.lax.fori_loop(
        1, _TEMME_ITERS + 1, lambda i, s: body(jnp.asarray(i), s), init
    )
    k_mu = summ
    k_mu1 = sum1 * (2.0 / x)
    return k_mu, k_mu1


def _cf2_pair(mu: float, x: jnp.ndarray):
    """(K_mu, K_{mu+1}) by Steed's continued fraction; accurate for x >= 2.

    Returns the *scaled* values e^x K, plus the scale handled by caller.
    """
    dtype = x.dtype
    eps = jnp.asarray(1e-16 if dtype == jnp.float64 else 1e-8, dtype)
    a1 = 0.25 - mu * mu

    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = jnp.zeros_like(x)
    q2 = jnp.ones_like(x)
    q = jnp.full_like(x, a1)
    c = jnp.full_like(x, a1)
    a = jnp.full_like(x, -a1)
    s = 1.0 + q * delh
    done = jnp.zeros_like(x, dtype=bool)

    def body(i, carry):
        b, d, h, delh, q1, q2, q, c, a, s, done = carry
        fi = i.astype(dtype)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | (jnp.abs(dels) < jnp.abs(s_n) * eps)

        # Freeze every carried quantity once converged: running the
        # recurrences past convergence overflows `c` in float32 (its
        # magnitude roughly doubles per iteration), and frozen lanes must
        # not pick up inf/NaN.
        def keep(old, new):
            return jnp.where(done, old, new)

        return (keep(b, b_n), keep(d, d_n), keep(h, h_n), keep(delh, delh_n),
                keep(q1, q2), keep(q2, qnew), keep(q, q_n), keep(c, c_n),
                keep(a, a_n), keep(s, s_n), done_n)

    init = (b, d, h, delh, q1, q2, q, c, a, s, done)
    out = jax.lax.fori_loop(
        2, _CF2_ITERS + 2, lambda i, st: body(jnp.asarray(i), st), init
    )
    h, s = out[2], out[9]
    h = a1 * h
    # scaled: e^x K_mu(x)
    k_mu_scaled = jnp.sqrt(jnp.pi / (2.0 * x)) / s
    k_mu1_scaled = k_mu_scaled * (mu + x + 0.5 - h) / x
    return k_mu_scaled, k_mu1_scaled


def _kv_pair_scaled(v: float, x: jnp.ndarray):
    """(e^x K_v(x), e^x K_{v+1}(x)) for static real v >= 0, element-wise x>0."""
    v = float(v)
    if v < 0:
        raise ValueError("bessel_kv: order must be >= 0 (K_{-v} = K_v)")
    nl = int(v + 0.5)
    mu = v - nl  # |mu| <= 1/2

    x_lo = jnp.minimum(x, 2.0)
    x_hi = jnp.maximum(x, 2.0)
    kt, kt1 = _temme_pair(mu, x_lo)
    scale_lo = jnp.exp(x_lo)  # x_lo <= 2, no overflow
    kc, kc1 = _cf2_pair(mu, x_hi)
    use_temme = x <= 2.0
    k = jnp.where(use_temme, kt * scale_lo, kc)
    k1 = jnp.where(use_temme, kt1 * scale_lo, kc1)

    # raise order mu -> v by the standard recurrence (unrolled; nl static)
    for j in range(nl):
        k, k1 = k1, 2.0 * (mu + j + 1.0) / x * k1 + k
    return k, k1


def bessel_kve_pair(v: float, x: jnp.ndarray):
    """Exponentially scaled pair (e^x K_v, e^x K_{v+1})."""
    return _kv_pair_scaled(v, jnp.asarray(x))


@partial(jax.custom_jvp, nondiff_argnums=(0,))
def bessel_kve(v: float, x: jnp.ndarray) -> jnp.ndarray:
    """Exponentially scaled e^x K_v(x) for static real order v >= 0."""
    return _kv_pair_scaled(v, jnp.asarray(x))[0]


@bessel_kve.defjvp
def _bessel_kve_jvp(v, primals, tangents):
    (x,) = primals
    (dx,) = tangents
    x = jnp.asarray(x)
    k, k1 = _kv_pair_scaled(v, x)
    # d/dx [e^x K_v] = e^x (K_v + K_v') ; K_v' = (v/x) K_v - K_{v+1}
    dk = k + (v / x) * k - k1
    return k, dk * dx


@partial(jax.custom_jvp, nondiff_argnums=(0,))
def bessel_kv(v: float, x: jnp.ndarray) -> jnp.ndarray:
    """K_v(x) for static real order v >= 0, element-wise in x > 0."""
    x = jnp.asarray(x)
    k, _ = _kv_pair_scaled(v, x)
    return k * jnp.exp(-x)


@bessel_kv.defjvp
def _bessel_kv_jvp(v, primals, tangents):
    (x,) = primals
    (dx,) = tangents
    x = jnp.asarray(x)
    ks, k1s = _kv_pair_scaled(v, x)
    e = jnp.exp(-x)
    k = ks * e
    # dK_v/dx = (v/x) K_v - K_{v+1}
    dk = (v / x) * k - k1s * e
    return k, dk * dx


def log_bessel_kv(v: float, x: jnp.ndarray) -> jnp.ndarray:
    """log K_v(x), stable for large x (no underflow)."""
    x = jnp.asarray(x)
    return jnp.log(bessel_kve(v, x)) - x
