"""CUDA kernel for R speculative Metropolis rounds of an SE/SE mixture.

`models.likelihood.make_mh_rounds` evaluates R whole speculative rounds
per call. On a GPU, inside the envelope below, those R rounds run as ONE
kernel launch (`cuda/mh_rounds.cu`): one thread block per chain, an
in-kernel loop over rounds, the K candidates' bordered Grams in shared
memory, one thread group per candidate. Elsewhere `make_mh_rounds` runs
its XLA scan, which is also the reference this kernel is checked against.

The CUDA source is compiled with nvcc at first use into `<repo>/build/`
(ignored by git); the build counts as set-up time. There is no interpret
mode: `reference_rounds` states the kernel's semantics on the same packed
inputs in plain JAX, so the packing, shapes and decoding around the
kernel are tested on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

MAX_K = 8            # candidates per round (kMaxK)
MAX_D = 16           # input dimensions (kMaxD)
MAX_N = 126          # rows n + 2 <= 128: four 32-row register slots a lane
# a block's shared memory on Hopper (227 KB) less the kernel's static part
SMEM_LIMIT = 227 * 1024 - 2048
ROUGH_CODES = {"free": 0, "tied": 1, "lambda": 2}

_SRC = Path(__file__).resolve().parent / "cuda" / "mh_rounds.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
_TARGET = "ccgp_mh_rounds"


class RoundsModel(NamedTuple):
    """Static description of the candidate model the kernel evaluates."""

    aniso: int
    rough: int
    priors: tuple        # ((code, a, b) for theta1, theta2, p)
    jitter: float


def _prior_code(prior) -> Optional[tuple]:
    from ccgp_tpu.models.priors import (InverseGamma, JeffreysUnit,
                                        LogNormal, Uniform01)

    if prior is None or isinstance(prior, Uniform01):
        return (0, 0.0, 0.0)
    if isinstance(prior, InverseGamma):
        return (1, float(prior.a), float(prior.b))
    if isinstance(prior, LogNormal):
        return (2, float(prior.mu), float(prior.sigma))
    if isinstance(prior, JeffreysUnit):
        return (3, 0.0, 0.0)
    return None


def rounds_model(spec, theta1_prior=None, theta2_prior=None, p_prior=None,
                 jitter: float = 0.0) -> Optional[RoundsModel]:
    """Encode (spec, priors) for the kernel; None when the kernel cannot
    evaluate this model (not an SE/SE mixture, or a prior it lacks)."""
    if not (spec.kernel1.raw_kind == "sqdist"
            and spec.kernel2.raw_kind == "sqdist"):
        return None
    codes = tuple(_prior_code(p) for p in (theta1_prior, theta2_prior,
                                           p_prior))
    if any(c is None for c in codes):
        return None
    return RoundsModel(aniso=int(spec.anisotropic),
                       rough=ROUGH_CODES[spec.rough], priors=codes,
                       jitter=float(jitter))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(n: int, d: int, k: int) -> int:
    """Dynamic shared memory of one block: the inputs, then per candidate
    its bordered (n+2) x n Gram and the two 4-column panels."""
    return 4 * (_round4(n * d) + k * (_round4((n + 2) * n) + 8 * n + 8))


def in_envelope(model: Optional[RoundsModel], n: int, d: int, k: int,
                dtype) -> bool:
    """Shapes and models the kernel takes: float32, K <= MAX_K,
    d <= MAX_D, n <= MAX_N, and K bordered Grams inside one block's
    shared memory (n <= 114 at K = 4)."""
    return (model is not None and jnp.dtype(dtype) == jnp.float32
            and 1 <= k <= MAX_K and 1 <= d <= MAX_D and 1 <= n <= MAX_N
            and smem_bytes(n, d, k) <= SMEM_LIMIT)


def use_kernel(model, n: int, d: int, k: int, dtype) -> bool:
    """The kernel runs iff the platform is a GPU and the call is inside
    its envelope; everything else takes the XLA scan."""
    return jax.default_backend() == "gpu" and in_envelope(model, n, d, k,
                                                          dtype)


def _nvcc() -> str:
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the mh_rounds kernel needs the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build_library() -> Path:
    """Compile cuda/mh_rounds.cu for sm_90a (cached by source hash)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libccgp_mh_rounds_{digest}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    tmp.replace(so)
    return so


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.CcgpMhRounds),
                                platform="CUDA")


def _ffi_rounds(x, y, state, consts, deltas, log_u, *, aniso, rough, prior1,
                prior2, prior_p):
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the mh_rounds CUDA kernel runs only on a GPU backend "
            f"(got {jax.default_backend()!r}); make_mh_rounds takes the "
            "XLA scan elsewhere")
    _register()
    rr, kk, dim = deltas.shape[-3:]
    f32 = jnp.float32
    out = (jax.ShapeDtypeStruct((rr, dim + 2), f32),
           jax.ShapeDtypeStruct((rr, 2), jnp.int32),
           jax.ShapeDtypeStruct((rr, kk), f32),
           jax.ShapeDtypeStruct((rr, kk), f32))
    return jax.ffi.ffi_call(_TARGET, out, vmap_method="broadcast_all")(
        x, y, state, consts, deltas, log_u, aniso=np.int64(aniso),
        rough=np.int64(rough), prior1=np.int64(prior1),
        prior2=np.int64(prior2), prior_p=np.int64(prior_p))


def reference_rounds(x, y, state, consts, deltas, log_u, *, aniso, rough,
                     prior1, prior2, prior_p):
    """What the kernel computes, on its packed inputs, in plain JAX (an
    explicit Cholesky instead of the kernel's elimination)."""
    n, d = x.shape
    rr, kk, dim = deltas.shape
    sigma2, jitter = consts[0], consts[1]
    pa = ((prior1, consts[2], consts[3]), (prior2, consts[4], consts[5]),
          (prior_p, consts[6], consts[7]))
    sq = (x[:, None, :] - x[None, :, :]) ** 2                  # (n, n, d)
    ones = jnp.ones_like(y)

    def log_kernel(code, a, b, v):
        lv = jnp.log(v)
        return {0: jnp.zeros_like(v), 1: -(a + 1.0) * lv - b / v,
                2: -lv - 0.5 * ((lv - a) / b) ** 2,
                3: -0.5 * (lv + jnp.log1p(-v))}[code]

    def logpost(cz):
        if aniso:
            th1, phi, th2 = jnp.exp(cz[:d]), cz[d], jnp.exp(cz[d + 1])
            log_jac = jnp.sum(cz[:d]) + cz[d + 1]
            lp1 = jnp.sum(log_kernel(*pa[0], th1))
        else:
            th1 = jnp.full((d,), jnp.exp(cz[0]))
            th2, phi = jnp.exp(cz[1]), cz[2]
            log_jac = cz[0] + cz[1]
            lp1 = log_kernel(*pa[0], th1[0])
        p = jax.nn.sigmoid(phi)
        log_jac = (log_jac + jax.nn.log_sigmoid(phi)
                   + jax.nn.log_sigmoid(-phi))
        r2 = (1.0 + th2) * th1 if rough == ROUGH_CODES["tied"] else \
            jnp.full((d,), th2)
        w1, w2 = p * p, (1.0 - p) ** 2
        g = (w1 * jnp.exp(-sq @ th1) + w2 * jnp.exp(-sq @ r2)) / (w1 + w2)
        chol = jnp.linalg.cholesky(g + jitter * jnp.eye(n, dtype=g.dtype))
        wy = jax.scipy.linalg.solve_triangular(chol, y, lower=True)
        wo = jax.scipy.linalg.solve_triangular(chol, ones, lower=True)
        qyy, qoy, qoo = wy @ wy, wy @ wo, wo @ wo
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        ls = jnp.log((w1 + w2) * sigma2)
        extra = (log_jac + lp1 + log_kernel(*pa[1], th2)
                 + log_kernel(*pa[2], p))
        val = (-0.5 * (n * math.log(2.0 * math.pi) + logdet + n * ls
                       + (qyy - qoy ** 2 / qoo) * jnp.exp(-ls)) + extra)
        return jnp.where(jnp.isfinite(val), val, -jnp.inf), qoy / qoo

    def step(st, rk):
        drow, lu = rk
        cands = st[None, :dim] + drow
        vals, betas = jax.vmap(logpost)(cands)
        acc = (vals - st[dim + 1]) > lu
        any_acc = jnp.any(acc)
        first = jnp.argmax(acc)
        new = jnp.where(any_acc, jnp.concatenate(
            [cands[first], betas[first][None], vals[first][None]]), st)
        consumed = jnp.where(any_acc, first + 1, kk)
        info = jnp.stack([any_acc.astype(jnp.int32),
                          consumed.astype(jnp.int32)])
        return new, (new, info, vals, betas)

    _, outs = jax.lax.scan(step, state, (deltas, log_u))
    return outs


def mh_rounds_gpu(model: RoundsModel, x, y, z, lp_val, lp_beta, sigma2,
                  deltas, log_u, impl=None) -> dict:
    """R speculative rounds; same contract as `make_mh_rounds`' XLA scan,
    plus each round's candidate log-posteriors `vals` (R, K) and
    intercepts `betas` (R, K). `impl` replaces the kernel by a function of
    the same packed interface (tests pass `reference_rounds`)."""
    rr, kk = log_u.shape
    dim = z.shape[-1]
    dt = z.dtype       # float32 on the kernel path (see in_envelope)
    state = jnp.concatenate([z, jnp.reshape(lp_beta, (1,)).astype(dt),
                             jnp.reshape(lp_val, (1,)).astype(dt)])
    consts = jnp.concatenate([
        jnp.reshape(sigma2, (1,)).astype(dt),
        jnp.asarray([model.jitter], dt),
        jnp.asarray([v for c in model.priors for v in c[1:]], dt)])
    codes = dict(aniso=model.aniso, rough=model.rough,
                 prior1=model.priors[0][0], prior2=model.priors[1][0],
                 prior_p=model.priors[2][0])
    rec, info, vals, betas = (impl or _ffi_rounds)(
        x.astype(dt), y.astype(dt), state, consts,
        deltas.astype(dt).reshape(rr, kk, dim), log_u.astype(dt), **codes)
    return {"rec": rec, "acc": info[:, 0] > 0, "consumed": info[:, 1],
            "z_fin": rec[rr - 1, :dim], "beta_fin": rec[rr - 1, dim],
            "val_fin": rec[rr - 1, dim + 1], "vals": vals, "betas": betas}


def compare_with_xla(spec, x, y, sigma2, z, deltas, log_u, *,
                     theta1_prior=None, theta2_prior=None, p_prior=None,
                     jitter: float = 0.0, impl=None) -> dict:
    """Run R rounds through the kernel (or `impl`) and re-evaluate every
    round's K candidates with the XLA batched log-posterior
    (`models.likelihood.make_logpost_batch`) on the kernel's own
    trajectory, so one rounding-level flip cannot desynchronise the two.

    Returns the worst relative log-posterior and intercept differences
    over finite candidates, the number of candidates finite on one side
    only, and the number of rounds whose accept decision differs by more
    than `val_err` allows."""
    from ccgp_tpu.models.likelihood import make_logpost, make_logpost_batch

    kw = dict(theta1_prior=theta1_prior, theta2_prior=theta2_prior,
              p_prior=p_prior, jitter=jitter)
    model = rounds_model(spec, **kw)
    lp0 = make_logpost(spec, x, y, sigma2, **kw)(z)
    out = jax.jit(lambda *a: mh_rounds_gpu(model, x, y, *a, impl=impl))(
        z, lp0.val, lp0.beta, sigma2, deltas, log_u)
    rr, kk = log_u.shape
    dim = z.shape[-1]
    state0 = jnp.concatenate([z, lp0.beta[None], lp0.val[None]])
    before = jnp.concatenate([state0[None], out["rec"][:-1]])
    cands = before[:, None, :dim] + deltas.reshape(rr, kk, dim)
    vals_x, betas_x = jax.jit(jax.vmap(make_logpost_batch(
        spec, x, y, sigma2, **kw)))(cands)

    vk, bk = np.asarray(out["vals"], np.float64), np.asarray(out["betas"],
                                                              np.float64)
    vx, bx = np.asarray(vals_x, np.float64), np.asarray(betas_x, np.float64)
    fin = np.isfinite(vk) & np.isfinite(vx)
    val_err = float(np.max(np.abs(vk - vx)[fin] / np.maximum(
        1.0, np.abs(vx[fin])), initial=0.0))
    beta_err = float(np.max(np.abs(bk - bx)[fin] / np.maximum(
        1.0, np.abs(bx[fin])), initial=0.0))
    # accept decisions: XLA's rule on the kernel's trajectory; a flip only
    # counts when its margin is beyond the measured value difference
    lpv = np.asarray(before[:, dim + 1], np.float64)[:, None]
    margin = vx - lpv - np.asarray(log_u, np.float64)
    acc_x = margin > 0
    first_x = np.where(acc_x.any(1), acc_x.argmax(1), kk)
    acc_k = np.asarray(out["acc"])
    first_k = np.where(acc_k, np.asarray(out["consumed"]) - 1, kk)
    tol = 2.0 * val_err * np.maximum(1.0, np.abs(vx)) + 1e-6
    clear = 0
    for r in range(rr):
        for k in range(min(first_k[r], kk - 1) + 1):
            if ((k == first_k[r]) != (margin[r, k] > 0)
                    and abs(margin[r, k]) > tol[r, k]):
                clear += 1
                break
    return {"rounds": rr, "candidates": rr * kk,
            "accepted_rounds": int(acc_k.sum()),
            "finite": int(fin.sum()),
            "finite_mismatch": int((np.isfinite(vk) != np.isfinite(vx)).sum()),
            "val_err": val_err, "beta_err": beta_err,
            "decision_flips": int((first_x != first_k).sum()),
            "clear_flips": clear}
