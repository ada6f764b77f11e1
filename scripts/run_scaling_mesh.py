"""Multi-device scaling evidence for the sharded runners.

On an 8-device virtual CPU mesh all devices timeshare the host's cores,
so wall-clock speedup is not what this shows. What it does show, per
workload:

  1. result parity: the sharded run returns the same numbers as the
     single-device run;
  2. per-device work: XLA's cost analysis of the compiled SPMD module —
     with the batch axis sharded over 8 devices, per-device FLOPs drop by
     ~8x, which is the quantity that becomes wall-clock speedup when each
     device is a real chip on its own silicon;
  3. wall-clock on this 1-core host (reported for completeness, expected
     ~1x).

Workloads: the EB hyperprior grid scan (rows sharded over 'dp') and the
multi-design simulation sweep (designs sharded over 'dp').

Usage: python scripts/run_scaling_mesh.py   (appends a block to RESULTS.md)
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_DEV = 8

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N_DEV}").strip()


def main():
    import jax

    from ccgp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    jax.config.update("jax_platforms", "cpu")
    # f64: f32 sharded/unsharded compilation variants round differently and
    # the MCMC accept chain amplifies a flipped comparison into a different
    # trajectory; parity is only meaningful at f64
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ccgp_tpu.eb.halton import halton
    from ccgp_tpu.eb.hyperpriors import marginal_likelihood
    from ccgp_tpu.models import MixtureSpec
    from ccgp_tpu.ops import kernels
    from ccgp_tpu.parallel import make_mesh

    dtype = jnp.float64
    rng = np.random.default_rng(0)
    lines = ["", f"## Multi-device scaling evidence ({N_DEV}-device virtual "
             "CPU mesh on a 1-core host)", "",
             "| workload | per-device GFLOPs (1 dev) | per-device GFLOPs "
             f"({N_DEV} dev) | work ratio | results | wall 1-dev | wall "
             f"{N_DEV}-dev |", "|---|---|---|---|---|---|---|"]

    # ---------------- workload 1: EB hyperprior grid scan ----------------
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    x = jnp.asarray(rng.uniform(size=(16, 2)), dtype)
    y = jnp.asarray(rng.normal(size=16), dtype)
    nodes = jnp.asarray(halton(256, 1)[:, 0], dtype)
    g = 64
    grid_np = np.column_stack([
        rng.uniform(2, 8, g), rng.uniform(1, 6, g),
        rng.uniform(2, 8, g), rng.uniform(10, 80, g)]).astype(np.float32)
    grid_j = jnp.asarray(grid_np)

    def scan_fn(grid_rows):
        # vmap (not lax.map): keeps the whole row sweep visible to XLA's
        # cost analysis so per-device FLOPs are attributable
        def row_ml(row):
            return marginal_likelihood(spec, x, y, (row[0], row[1]),
                                       (row[2], row[3]), 1.0, nodes,
                                       tau=50.0, jitter=1e-5)
        return jax.vmap(row_ml)(grid_rows)

    results = {}
    for ndev in (1, N_DEV):
        mesh = make_mesh(ndev)
        shard = NamedSharding(mesh, P(("dp", "mp")))
        gin = jax.device_put(grid_j, shard)
        jf = jax.jit(scan_fn, in_shardings=shard, out_shardings=shard)
        compiled = jf.lower(gin).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        gflops = float(cost.get("flops", float("nan"))) / 1e9
        out = np.asarray(compiled(gin))  # warmup
        t0 = time.perf_counter()
        out = np.asarray(compiled(gin))
        dt = time.perf_counter() - t0
        results[ndev] = (gflops, out, dt)

    same = np.allclose(results[1][1], results[N_DEV][1], rtol=1e-9)
    ratio = results[1][0] / results[N_DEV][0]
    lines.append(
        f"| EB hyperprior scan (64 rows x 256 nodes, n=16) | "
        f"{results[1][0]:.2f} | {results[N_DEV][0]:.2f} | {ratio:.1f}x | "
        f"{'identical (1e-9)' if same else 'MISMATCH'} | "
        f"{results[1][2]:.2f}s | {results[N_DEV][2]:.2f}s |")
    assert same, "sharded hyperpar scan diverged from single-device"

    # ---------------- workload 2: multi-design simulation sweep ----------
    from ccgp_tpu.experiments import sim_2d_sweep
    from ccgp_tpu.models import MCMCConfig

    fam = kernels.sqexp_family()
    cfg = sim_2d_sweep.Config(
        n_designs=16, n_new_axis=9,
        mcmc=MCMCConfig(start=(1.0, 1.0, 0.0), n_max=800, samp_size=200,
                        net_samp_size=150))
    from ccgp_tpu.eval.datasets import load_2d_training_design
    from ccgp_tpu.eval.functions import test_function_2d

    designs = jnp.asarray(np.stack([load_2d_training_design(i + 1)
                                    for i in range(cfg.n_designs)]), dtype)
    u = np.linspace(0, 1, cfg.n_new_axis)
    xg = jnp.asarray(np.stack(np.meshgrid(u, u), -1).reshape(-1, 2), dtype)
    y_true = test_function_2d(xg, cfg.func)
    mle_grid_np = np.linspace(-2.0, 5.0, 32, dtype=np.float32)
    study_one = sim_2d_sweep._study_one_fn(cfg, fam, spec, xg, y_true,
                                           mle_grid_np, dtype)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.n_designs)

    results = {}
    for ndev in (1, N_DEV):
        mesh = make_mesh(ndev)
        shard = NamedSharding(mesh, P(("dp", "mp")))
        din = jax.device_put(designs, shard)
        kin = jax.device_put(keys, shard)
        jf = jax.jit(jax.vmap(study_one), in_shardings=(shard, shard))
        compiled = jf.lower(din, kin).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        gflops = float(cost.get("flops", float("nan"))) / 1e9
        out = jax.block_until_ready(compiled(din, kin))  # warmup
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(din, kin))
        dt = time.perf_counter() - t0
        results[ndev] = (gflops, np.asarray(out[0]), dt)

    same = np.allclose(results[1][1], results[N_DEV][1], rtol=1e-9)
    ratio = results[1][0] / results[N_DEV][0]
    lines.append(
        f"| design sweep (16 Train_Designs, full MCMC each) | "
        f"{results[1][0]:.2f} | {results[N_DEV][0]:.2f} | {ratio:.1f}x | "
        f"{'identical (1e-9)' if same else 'MISMATCH'} | "
        f"{results[1][2]:.2f}s | {results[N_DEV][2]:.2f}s |")
    assert same, "sharded design sweep diverged from single-device"

    lines += [
        "",
        "Per-device FLOPs are XLA cost analysis of the compiled SPMD "
        "module: the sharded module does ~1/8 the work per device, which "
        "is the wall-clock speedup on real multi-chip hardware (each "
        "device on its own silicon). Wall-clock here timeshares one host "
        "core across all 8 virtual devices, so it stays ~1x by "
        "construction.",
    ]
    print("\n".join(lines))
    with open(ROOT / "RESULTS.md", "a") as fh:
        fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
