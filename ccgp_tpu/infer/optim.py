"""On-device optimization: BFGS with multistart batching.

The reference scatters optimizer calls everywhere — `nlminb` with random
restarts for the kriging MLE (`1D Codes and Designs/1D Combined GP
Public.R:455-471`), `optim(L-BFGS-B)` for the CGP baseline
(`1D...Public.R:156-161`) and the design search (`Batch Sequential ME
Designs/Batch Sequential ME Design.R:900`). The batched equivalent is one
vmapped BFGS: every restart is a batch lane of the same compiled kernel, so
a 25-start search costs one kernel launch instead of 25 serial optimizations.

Box constraints are handled by the smooth tanh reparameterization
(`ccgp_tpu.utils.transforms.tanh_box`), keeping the problem unconstrained
and the compiled graph branch-free.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.optimize import minimize as _jsp_minimize

from ccgp_tpu.utils import transforms


class MultistartResult(NamedTuple):
    x: jnp.ndarray          # best point found (constrained space)
    fun: jnp.ndarray        # objective value at x
    xs: jnp.ndarray         # all restart solutions
    funs: jnp.ndarray       # all restart objective values


def _guard(fn):
    """Make an objective safe for quasi-Newton line searches.

    Non-finite values become a large constant AND their gradients become
    zero: a plain `where` on the value still lets NaN cotangents flow
    through the non-finite branch and poison the BFGS state (observed on
    the float32 path, where singular Grams appear earlier than in
    float64). Implemented as a custom-VJP wrapper so both the primal and
    the pullback are sanitized.
    """

    @jax.custom_vjp
    def safe(z):
        v = fn(z)
        return jnp.where(jnp.isfinite(v), v, jnp.asarray(1e10, v.dtype))

    def fwd(z):
        v, pullback = jax.vjp(fn, z)
        ok = jnp.isfinite(v)
        v = jnp.where(ok, v, jnp.asarray(1e10, v.dtype))
        return v, (pullback, ok)

    def bwd(res, g):
        pullback, ok = res
        (gz,) = pullback(jnp.where(ok, g, jnp.zeros_like(g)))
        gz = jnp.where(jnp.isfinite(gz), gz, jnp.zeros_like(gz))
        return (jnp.where(ok, gz, jnp.zeros_like(gz)),)

    safe.defvjp(fwd, bwd)
    return safe


def minimize_bfgs(fn, x0: jnp.ndarray, maxiter: int = 100):
    """Unconstrained BFGS minimization (jit/vmap-compatible)."""
    res = _jsp_minimize(_guard(fn), x0, method="BFGS",
                        options={"maxiter": maxiter})
    return res.x, res.fun


def multistart_minimize(
    fn,
    starts: jnp.ndarray,
    lower: Optional[jnp.ndarray] = None,
    upper: Optional[jnp.ndarray] = None,
    maxiter: int = 100,
) -> MultistartResult:
    """Minimize fn from many starts in parallel; optionally box-constrained.

    starts: (k, d) in *constrained* space when bounds are given.
    """
    bounded = lower is not None
    if bounded:
        lower = jnp.asarray(lower, starts.dtype)
        upper = jnp.asarray(upper, starts.dtype)

        def obj(u):
            return fn(transforms.tanh_box(u, lower, upper))

        z0 = jax.vmap(lambda s: transforms.tanh_box_inverse(s, lower, upper))(starts)
    else:
        obj = fn
        z0 = starts

    xs, _ = jax.vmap(lambda z: minimize_bfgs(obj, z, maxiter))(z0)
    # jax.scipy's BFGS can report a `fun` that does NOT correspond to its
    # final `x` (observed: a line search wandering into a guarded/invalid
    # region returns the pre-wander value with the post-wander point, and
    # that stale value then wins the argmin while the point is garbage).
    # Re-evaluate the true objective at every restart solution instead of
    # trusting the optimizer's reported value.
    funs = jax.vmap(obj)(xs)
    if bounded:
        xs = jax.vmap(lambda u: transforms.tanh_box(u, lower, upper))(xs)
    # non-finite restarts lose
    funs = jnp.where(jnp.isfinite(funs), funs, jnp.inf)
    best = jnp.argmin(funs)
    return MultistartResult(x=xs[best], fun=funs[best], xs=xs, funs=funs)
