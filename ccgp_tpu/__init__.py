"""ccgp_tpu — convex-combination-of-Gaussian-processes framework in JAX.

A from-scratch JAX / XLA re-design of the capabilities of
`oharari/Convex-Combination-of-Gaussian-Processes` (Harari & Steinberg,
Technometrics 2014): Bayesian "combined GP" emulation of deterministic
computer experiments, where the prior mixes a smooth and a rough GP via a
convex combination of correlation functions,

    Y(x) = beta + sigma * (p * Z1(x) + (1 - p) * Z2(x)),

implying the mixed correlation

    R_mix = (p^2 R1 + (1 - p)^2 R2) / (p^2 + (1 - p)^2).

Subpackages
-----------
ops        kernels (Matern / cubic-spline / squared-exponential), pairwise
           distances, Cholesky/log-det linalg, and a CUDA kernel for the
           speculative Metropolis rounds on GPUs.
models     convex-combination covariance, priors, transformed log-posterior,
           the CombinedGP model, ordinary-kriging and composite-GP baselines.
infer      on-device L-BFGS MLE, Laplace approximation, Metropolis sampler
           with Geweke stopping, multi-chain vmapping.
predict    per-draw factor caches and posterior-predictive aggregation.
design     maximum-entropy designs (initial + batch-sequential Schur
           criterion), multistart optimizers, LHS, k-medoids.
eb         empirical-Bayes hyperprior selection by Halton-QMC marginal
           likelihood.
eval       compare harness (RMSPE / coverage / calibration), datasets,
           closed-form test functions.
parallel   mesh / sharding utilities for multi-chip sweeps.
utils      transforms, distributions, stats helpers, configs.

Everything is pure-functional and jit-friendly; batch axes (posterior draws,
MCMC chains, design restarts, hyperprior grid rows, test points) are vmapped
and optionally sharded over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"
