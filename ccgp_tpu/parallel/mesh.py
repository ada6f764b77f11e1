"""Device-mesh helpers.

The reference is single-process R with no parallelism of any kind
(SURVEY.md section 2.5); multi-chip scaling here is new design work. The
natural parallel axes of the combined-GP workload are all *batch* axes —
MCMC chains, posterior draws, design restarts, hyperprior grid rows,
simulation-study designs, test points — so the sharding story is:

  * 'dp' (data/batch parallel): independent chains / designs / grid rows,
    no communication except final reductions (psum of summaries);
  * 'mp' (model parallel): test-point or node axes of a single evaluation;
    reductions over 'mp' are XLA-inserted psums.

The devices of one host are joined all to all, so the mesh shape follows
the algorithm alone.

Single-chip execution is the n=1 mesh — the same jitted code runs anywhere.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "mp"),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first n_devices devices.

    Default factorization puts everything on 'dp' (embarrassingly parallel
    batch axes) with 'mp' = 1 unless a 2-factor shape is given.
    """
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    n = len(devs)
    if shape is None:
        # largest power-of-two split for mp up to 2 keeps dp dominant
        mp = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (n // mp, mp)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def data_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading dimension over `axis`, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
