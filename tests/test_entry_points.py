"""Entry points and process-level settings: chip_smoke.py refuses a
machine without a GPU, the CLI refuses a mesh larger than the devices it
sees, the compile cache follows JAX_COMPILATION_CACHE_DIR, and the
seeded designs the GPU smoke run uses are deterministic Latin
hypercubes."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, extra_env=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
               **(extra_env or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([str(tmp_path / "chip_smoke.py")], tmp_path,
             extra_env={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_CACHE_PROBE = (
    "import jax\n"
    "from ccgp_tpu.utils.cache import enable_persistent_cache\n"
    "p = enable_persistent_cache()\n"
    "print(p)\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


def test_compile_cache_uses_env_dir(tmp_path):
    cache = tmp_path / "cc"
    r = _run(["-c", _CACHE_PROBE + "jax.jit(lambda v: v * 2 + 1)(1.0)"
              ".block_until_ready()\n"], tmp_path,
             extra_env={"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert r.returncode == 0, r.stderr
    path, configured = r.stdout.split()[:2]
    assert path == configured == str(cache)
    assert any(cache.iterdir())            # the compile landed there


def test_compile_cache_default_is_repo_dir(tmp_path):
    r = _run(["-c", _CACHE_PROBE], tmp_path,
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    path, configured = r.stdout.split()[:2]
    assert path == configured == str(ROOT / ".jax_cache")


def test_cli_mesh_needs_enough_devices(capsys):
    from ccgp_tpu.__main__ import main

    n = len(jax.devices())
    with pytest.raises(SystemExit):
        main(["sim_2d_sweep", "--mesh", str(n + 1)])
    assert f"only {n}" in capsys.readouterr().err


def _assert_lhs(x):
    n = x.shape[0]
    for col in x.T:
        strata = np.floor(col * n).astype(int)
        assert sorted(strata) == list(range(n))


def test_flagship_design_is_a_seeded_lhs():
    from ccgp_tpu.experiments import flagship

    x = flagship.design()
    assert x.shape == (100, 2) and x.dtype == np.float64
    _assert_lhs(x)
    assert np.array_equal(x, flagship.design())
    assert not np.array_equal(x, flagship.design(seed=1))


def test_sweep_seeded_designs():
    from ccgp_tpu.experiments.sim_2d_sweep import seeded_designs

    d = seeded_designs(3)
    assert d.shape == (3, 14, 2)
    for x in d:
        _assert_lhs(x)
    assert not np.array_equal(d[0], d[1])


def test_flagship_map_program_cpu():
    """The MAP program chip_smoke.py times, at full width on the CPU in
    float64: finite, and as accurate as its guard demands."""
    import jax.numpy as jnp

    from ccgp_tpu.experiments import flagship

    x, y, grid, y_true = flagship.inputs(jnp.float64)
    mean, var, z_map, s2 = jax.jit(flagship.map_fit_predict)(x, y, grid)
    mean = np.asarray(mean)
    assert mean.shape == y_true.shape and np.isfinite(mean).all()
    assert np.all(np.asarray(var) > -1e-9) and float(s2) > 0
    assert np.sqrt(np.mean((y_true - mean) ** 2)) < 0.02


def test_sweep_on_a_mesh_matches_unsharded():
    """sim_2d_sweep on a 2-device mesh gives the unsharded results."""
    import jax.numpy as jnp

    from ccgp_tpu.experiments import sim_2d_sweep as sw
    from ccgp_tpu.models import MCMCConfig

    designs = sw.seeded_designs(2)
    mcmc = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=200, samp_size=60,
                      net_samp_size=40)
    out = [sw.run(sw.Config(n_designs=2, mesh_devices=m, n_new_axis=5,
                            mcmc=mcmc), key=jax.random.PRNGKey(1),
                  dtype=jnp.float64, designs=designs) for m in (0, 2)]
    for f in ("rmspe", "coverage", "quant", "chain_ok"):
        assert np.allclose(getattr(out[0], f), getattr(out[1], f),
                           rtol=1e-9), f
