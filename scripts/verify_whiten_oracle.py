"""Adjudicate the whitened-quadratic fallback (`make_logpost(whiten=True)`)
against a CPU-f64 oracle at the sizes where f32 bordered quadratics lose
accuracy to cancellation (n >= 768; DESIGN.md).

For each n in (512, 768, 1024) this script builds an SE-mixture problem,
draws unconstrained z points, and computes the centered Gaussian quadratic
  quad = (y - beta 1)' R^{-1} (y - beta 1)
three ways on the SAME f32 Gram:
  bordered   f32 `linalg.bordered_cholesky_quadratics` (qyy - qoy^2/qoo —
             the default hot path and what the CUDA rounds kernel
             accumulates)
  whitened   f32 explicit Cholesky + one extra triangular solve of the
             PRE-CENTERED residual y - beta (the whiten=True path)
  oracle     scipy f64 of the same f32 Gram
and reports each f32 path's max relative error from the oracle, plus the
end-to-end `make_logpost` val disagreement (whiten=False vs True).

Measured adjudication (recorded in RESULTS.md): on CENTERED data
(qyy/quad ~1) both paths sit at the same f32-factorization error floor
(~3-6e-4) — the bordered subtraction loses nothing, whiten=False stays
the right default. On UNCENTERED data (y offset 1000, qyy/quad ~2e3)
the bordered form degrades ~7x (3.0e-3 vs 4.2e-4 max rel at n=768) —
the regime `whiten=True` exists for. Runs on CPU — cancellation is a
dtype property, not a backend one (the GPU f32 kernel accumulates the
same bordered sums).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import scipy.linalg as sla

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from ccgp_tpu.models import InverseGamma, LogNormal, MixtureSpec
from ccgp_tpu.models.combination import mixed_gram, unpack
from ccgp_tpu.models.likelihood import make_logpost
from ccgp_tpu.ops import kernels, linalg

JITTER = 1e-3
N_Z = 8


def main():
    rng = np.random.default_rng(42)
    for n, offset in ((512, 0.0), (768, 0.0), (1024, 0.0),
                      (768, 1000.0), (1024, 1000.0)):
        x_np = rng.uniform(size=(n, 2)).astype(np.float32)
        # offset=0: centered data (the bench/reference regime) — qyy/quad
        # ~1, the bordered subtraction loses nothing, both paths sit at the
        # f32-factorization error floor. offset=1000: |E y| >> residual
        # scale, the intercept absorbs most of qyy and the bordered form
        # subtracts two large near-equal sums (qyy/quad ~2e3 below) — the
        # uncentered-data regime the whitened fallback exists for (measured
        # ~9x accuracy win at n=768).
        y_np = (offset + np.sin(5 * x_np[:, 0]) * np.cos(3 * x_np[:, 1])
                + 0.05 * rng.normal(size=n)).astype(np.float32)
        x = jnp.asarray(x_np)
        y = jnp.asarray(y_np)
        spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                           dim=2, rough="tied", anisotropic=True)
        zs = (rng.normal(size=(N_Z, 4)) * 0.5 + [0.5, 0.5, 0.0, 0.0]
              ).astype(np.float32)

        lp_b = make_logpost(spec, x, y, 0.05, theta1_prior=LogNormal(-1, 1),
                            theta2_prior=InverseGamma(3, 4), jitter=JITTER)
        lp_w = make_logpost(spec, x, y, 0.05, theta1_prior=LogNormal(-1, 1),
                            theta2_prior=InverseGamma(3, 4), jitter=JITTER,
                            whiten=True)

        errs = {"bordered": [], "whitened": []}
        val_gap = []
        cancel = []        # qyy/quad: how much the bordered subtraction loses
        for z in zs:
            zj = jnp.asarray(z)
            params, _ = unpack(spec, zj)
            r32 = np.asarray(mixed_gram(spec, x, params), np.float32)

            # f64 oracle on the SAME f32 Gram
            g64 = r32.astype(np.float64) + JITTER * np.eye(n)
            L = sla.cholesky(g64, lower=True)
            a = sla.solve_triangular(L, y_np.astype(np.float64), lower=True)
            b = sla.solve_triangular(L, np.ones(n), lower=True)
            beta64 = (a @ b) / (b @ b)
            quad64 = float((a - beta64 * b) @ (a - beta64 * b))

            q32 = linalg.bordered_cholesky_quadratics(
                jnp.asarray(r32), y, JITTER)
            quad_b = float(q32["qyy"] - q32["qoy"] ** 2 / q32["qoo"])

            chol32 = linalg.jitter_cholesky(jnp.asarray(r32), JITTER)
            wy = linalg.tri_solve(chol32, y)
            wo = linalg.tri_solve(chol32, jnp.ones_like(y))
            beta32 = jnp.sum(wo * wy) / jnp.sum(wo * wo)
            # the library's whiten path: center FIRST (original space),
            # then whiten — `wy - beta*wo` would re-subtract two large
            # near-equal whitened vectors and lose the same digits the
            # bordered form does (measured: post-centering 1.7e-3 vs
            # pre-centering 4.2e-4 max rel at n=768, offset 1000)
            w = linalg.tri_solve(chol32, y - beta32)
            quad_w = float(jnp.sum(w * w))

            errs["bordered"].append(abs(quad_b - quad64) / abs(quad64))
            errs["whitened"].append(abs(quad_w - quad64) / abs(quad64))
            cancel.append(float(q32["qyy"]) / quad64)
            vb, vw = lp_b(zj).val, lp_w(zj).val
            val_gap.append(abs(float(vb) - float(vw))
                           / max(abs(float(vb)), 1.0))

        print(json.dumps({
            "n": n,
            "y_offset": offset,
            "quad_rel_err_bordered_max": float(np.max(errs["bordered"])),
            "quad_rel_err_whitened_max": float(np.max(errs["whitened"])),
            "quad_rel_err_bordered_med": float(np.median(errs["bordered"])),
            "quad_rel_err_whitened_med": float(np.median(errs["whitened"])),
            "logpost_val_rel_gap_max": float(np.max(val_gap)),
            "cancellation_qyy_over_quad_max": float(np.max(cancel)),
        }), flush=True)
    print("DONE verify_whiten_oracle")


if __name__ == "__main__":
    main()
