"""CLI: run a reference case study by name.

    python -m ccgp_tpu <experiment> [--fast] [--seed N] [--cpu] [--f64]

Experiments: sim_1d, sim_1d_two_families, sim_2d_iso, sim_2d_iso_advanced,
sim_2d_aniso, batch_me_design, heat_exchanger, ground_vibrations.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ccgp_tpu",
                                 description=__doc__)
    ap.add_argument("experiment", choices=[
        "sim_1d", "sim_1d_two_families", "sim_2d_iso",
        "sim_2d_iso_advanced", "sim_2d_aniso", "batch_me_design",
        "heat_exchanger", "ground_vibrations", "sim_2d_sweep"])
    ap.add_argument("--fast", action="store_true",
                    help="small MCMC budget (smoke-test scale)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (with --mesh N: N virtual "
                         "CPU devices)")
    ap.add_argument("--f64", action="store_true",
                    help="enable float64 (the CPU and the GPU compute it "
                         "natively; default float32)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the sweep's design axis over an N-device "
                         "mesh of real devices (or virtual CPU devices "
                         "with --cpu); sim_2d_sweep only")
    ap.add_argument("--designs", type=int, default=0,
                    help="number of shipped Train_Designs to sweep "
                         "(sim_2d_sweep only)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="evaluate K speculative Metropolis proposals per "
                         "round as one batched factorization (a CUDA "
                         "kernel on a GPU) — same Markov kernel "
                         "(DESIGN.md \u00a78)")
    args = ap.parse_args(argv)

    import os

    if args.cpu and args.mesh > 1:
        # must happen before the JAX backend initializes (same recipe as
        # __graft_entry__.dryrun_multichip / tests/conftest.py)
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.mesh}"
            ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.mesh > len(jax.devices()):
        ap.error(f"--mesh {args.mesh}: only {len(jax.devices())} "
                 f"{jax.devices()[0].platform} device(s); add --cpu for "
                 "virtual CPU devices")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from ccgp_tpu import experiments as ex
    from ccgp_tpu.models import MCMCConfig

    mod = getattr(ex, args.experiment)
    cfg = mod.Config()
    if args.experiment == "sim_2d_sweep":
        over = {}
        if args.mesh:
            over["mesh_devices"] = args.mesh
        if args.designs:
            over["n_designs"] = args.designs
        if over:
            cfg = type(cfg)(**{**cfg.__dict__, **over})
    if args.fast:
        base = cfg.mcmc
        cfg = type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
            start=base.start, n_max=1200, samp_size=300, net_samp_size=200,
            batch_size=base.batch_size, alpha_geweke=base.alpha_geweke,
            record=base.record)})
    if args.speculative > 1:
        if hasattr(cfg, "mcmc"):
            base = cfg.mcmc
            cfg = type(cfg)(**{**cfg.__dict__, "mcmc": MCMCConfig(
                **{**base.__dict__, "speculative": args.speculative})})
        else:
            import sys

            print(f"warning: --speculative={args.speculative} ignored — "
                  f"experiment '{args.experiment}' has no MCMC stage",
                  file=sys.stderr)
    key = jax.random.PRNGKey(args.seed)
    dtype = jnp.float64 if args.f64 else jnp.float32
    out = mod.run(cfg, key=key, dtype=dtype)

    if hasattr(out, "summary") and out.summary is not None:
        s = out.summary
        print("RMSPE:     ",
              " | ".join(f"{k} {v:.4f}" for k, v in s.rmspe.items()))
        if s.coverage:
            print("coverage:  ",
                  " | ".join(f"{k} {v:.3f}" for k, v in s.coverage.items()))
        if s.average_quantile is not None:
            print(f"calibration quantile: {s.average_quantile:.3f} "
                  "(ideal 0.5)")
    if hasattr(out, "d_second"):
        print("second-batch design:")
        import numpy as np
        print(np.round(np.asarray(out.d_second), 4))
    if hasattr(out, "rmspe") and hasattr(out, "chain_ok"):
        import numpy as np
        m = len(out.rmspe)
        print(f"sweep over {m} designs "
              f"(mesh={args.mesh or 1} device(s)):")
        print(f"  RMSPE median {np.median(out.rmspe):.4f}, "
              f"IQR [{np.quantile(out.rmspe, .25):.4f}, "
              f"{np.quantile(out.rmspe, .75):.4f}]")
        print(f"  coverage median {np.median(out.coverage):.3f} | "
              f"calibration mean {out.quant.mean():.3f} | "
              f"healthy chains {int(out.chain_ok.sum())}/{m}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
