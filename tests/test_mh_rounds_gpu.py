"""The CUDA multi-round kernel's surroundings on the CPU: model encoding,
envelope and kernel selection, and the wrapper's packing, shapes and
decoding, checked by running the wrapper over `reference_rounds` (the
kernel's semantics in plain JAX) against the XLA scan it replaces.
The kernel itself runs in `test_kernel_matches_xla_on_gpu`, which skips
without a card (chip_smoke.py runs the same check on one)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccgp_tpu.models import (InverseGamma, JeffreysUnit, LogNormal,
                             MixtureSpec, Uniform01, make_logpost)
from ccgp_tpu.models.likelihood import make_mh_rounds
from ccgp_tpu.ops import kernels
from ccgp_tpu.ops import mh_rounds_gpu as G

SE = kernels.sqexp_family()

CONFIGS = {
    "aniso-tied-ln-ig": (MixtureSpec(SE, SE, dim=2, rough="tied",
                                     anisotropic=True),
                         LogNormal(-1, 1), InverseGamma(3, 4), None),
    "iso-free-ig-ig": (MixtureSpec(SE, SE, dim=2),
                       InverseGamma(3, 2), InverseGamma(5, 16), None),
    "iso-tied-jeffreys": (MixtureSpec(SE, SE, dim=3, rough="tied"),
                          InverseGamma(3, 2), InverseGamma(5, 16),
                          JeffreysUnit()),
    "aniso-lambda-uniform": (MixtureSpec(SE, SE, dim=3, rough="lambda",
                                         anisotropic=True),
                             LogNormal(0, 2), InverseGamma(3, 4),
                             Uniform01()),
    "iso-free-flat": (MixtureSpec(SE, SE, dim=1), None, None, None),
}


def _problem(spec, n=14, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(size=(n, spec.dim)))
    y = jnp.sin(5 * x[:, 0]) + jnp.cos(3 * x[:, -1])
    return x, y


def _rounds_inputs(dim, rr=8, kk=4, seed=1, scale=0.3):
    rng = np.random.default_rng(seed)
    deltas = jnp.asarray(scale * rng.normal(size=(rr * kk, dim)))
    log_u = jnp.asarray(np.log(rng.uniform(size=(rr, kk))))
    return deltas, log_u


@pytest.mark.parametrize("name,kk", [(n, 4) for n in sorted(CONFIGS)]
                         + [("aniso-tied-ln-ig", 1), ("aniso-tied-ln-ig", 2)])
def test_wrapper_matches_xla_scan(name, kk):
    spec, p1, p2, pp = CONFIGS[name]
    x, y = _problem(spec)
    s2 = jnp.asarray(0.3)
    kw = dict(theta1_prior=p1, theta2_prior=p2, p_prior=pp, jitter=1e-8)
    z = jnp.zeros(spec.n_params).at[0].set(0.5)
    lp = make_logpost(spec, x, y, s2, **kw)(z)
    deltas, log_u = _rounds_inputs(spec.n_params, kk=kk)
    want = make_mh_rounds(spec, x, y, s2, **kw)(z, lp.val, lp.beta, deltas,
                                                log_u)
    model = G.rounds_model(spec, p1, p2, pp, 1e-8)
    got = G.mh_rounds_gpu(model, x, y, z, lp.val, lp.beta, s2, deltas, log_u,
                          impl=G.reference_rounds)
    assert int(np.sum(want["acc"])) >= 1
    assert np.array_equal(np.asarray(got["acc"]), np.asarray(want["acc"]))
    assert np.array_equal(np.asarray(got["consumed"]),
                          np.asarray(want["consumed"]))
    for k in ("rec", "z_fin", "val_fin", "beta_fin"):
        assert got[k].shape == want[k].shape, k
        assert np.allclose(np.asarray(got[k]), np.asarray(want[k]),
                           rtol=1e-8, atol=1e-8), k
    assert got["vals"].shape == got["betas"].shape == log_u.shape


def test_wrapper_batches_under_vmap():
    """Chains batched by vmap (the kernel's one-block-per-chain grid)
    give each chain's own rounds."""
    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec)
    model = G.rounds_model(spec, p1, p2, pp, 1e-8)
    zs = jnp.asarray(np.random.default_rng(4).normal(size=(3, 4)) * 0.3)
    lp = make_logpost(spec, x, y, 0.3, theta1_prior=p1, theta2_prior=p2,
                      jitter=1e-8)
    vals = jax.vmap(lambda q: lp(q).val)(zs)
    betas = jax.vmap(lambda q: lp(q).beta)(zs)
    deltas, log_u = _rounds_inputs(4, rr=5)

    def run(z, v, b):
        return G.mh_rounds_gpu(model, x, y, z, v, b, jnp.asarray(0.3),
                               deltas, log_u, impl=G.reference_rounds)

    batched = jax.vmap(run)(zs, vals, betas)
    for i in range(3):
        one = run(zs[i], vals[i], betas[i])
        for k in ("rec", "acc", "consumed"):
            assert np.array_equal(np.asarray(batched[k][i]),
                                  np.asarray(one[k])), (i, k)


def test_rounds_model_encoding():
    spec = CONFIGS["aniso-tied-ln-ig"][0]
    m = G.rounds_model(spec, LogNormal(-1, 1), InverseGamma(3, 4),
                       JeffreysUnit(), jitter=1e-3)
    assert m == G.RoundsModel(aniso=1, rough=1,
                              priors=((2, -1.0, 1.0), (1, 3.0, 4.0),
                                      (3, 0.0, 0.0)), jitter=1e-3)
    assert G.rounds_model(spec, object()) is None        # unknown prior
    matern = kernels.matern_family(2.5)
    assert G.rounds_model(MixtureSpec(matern, matern)) is None


@pytest.mark.parametrize("n,d,k,dtype,inside", [
    (100, 2, 4, jnp.float32, True),      # the flagship
    (114, 2, 4, jnp.float32, True),      # largest n at K = 4
    (115, 2, 4, jnp.float32, False),     # K Grams exceed shared memory
    (126, 2, 2, jnp.float32, True),      # largest n: 128 register rows
    (127, 2, 1, jnp.float32, False),
    (100, 2, 4, jnp.float64, False),     # float32 only
    (40, 2, 9, jnp.float32, False),      # K > MAX_K
    (40, 17, 2, jnp.float32, False),     # d > MAX_D
])
def test_kernel_envelope(n, d, k, dtype, inside):
    model = G.rounds_model(CONFIGS["aniso-tied-ln-ig"][0])
    assert G.in_envelope(model, n, d, k, dtype) is inside
    assert G.in_envelope(None, n, d, k, dtype) is False
    assert (G.smem_bytes(n, d, k) <= G.SMEM_LIMIT) is (
        inside or dtype != jnp.float32 or k > G.MAX_K or d > G.MAX_D
        or n > G.MAX_N)


def test_kernel_never_selected_on_cpu():
    model = G.rounds_model(CONFIGS["aniso-tied-ln-ig"][0])
    assert jax.default_backend() == "cpu"
    assert not G.use_kernel(model, 100, 2, 4, jnp.float32)


def test_direct_kernel_call_on_cpu_raises():
    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec)
    model = G.rounds_model(spec, p1, p2, pp, 1e-3)
    deltas, log_u = _rounds_inputs(4)
    f32 = jnp.float32
    with pytest.raises(RuntimeError, match="only on a GPU"):
        G.mh_rounds_gpu(model, x.astype(f32), y.astype(f32),
                        jnp.zeros(4, f32), jnp.asarray(-10.0, f32),
                        jnp.asarray(0.0, f32), jnp.asarray(0.3, f32),
                        deltas.astype(f32), log_u.astype(f32))


@pytest.mark.parametrize("n,whiten,uses_kernel", [
    (30, False, True),
    (30, True, False),     # whiten always takes the scan
    (115, False, False),   # outside the shared-memory envelope
])
def test_make_mh_rounds_selects_kernel_on_gpu(monkeypatch, n, whiten,
                                              uses_kernel):
    """With the platform reporting a GPU, make_mh_rounds routes f32 calls
    inside the envelope to the kernel and everything else to the scan."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[4].shape)
        return G.reference_rounds(*a, **kw)

    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec, n=n)
    f32 = jnp.float32
    x, y = x.astype(f32), y.astype(f32)
    deltas, log_u = _rounds_inputs(4, rr=3)
    monkeypatch.setattr(G, "_ffi_rounds", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    fn = make_mh_rounds(spec, x, y, jnp.asarray(0.3, f32), theta1_prior=p1,
                        theta2_prior=p2, jitter=1e-3, whiten=whiten)
    out = fn(jnp.zeros(4, f32), jnp.asarray(-1e4, f32),
             jnp.asarray(0.0, f32), deltas.astype(f32), log_u.astype(f32))
    assert out["rec"].shape == (3, 6)
    assert (calls == [(3, 4, 4)]) is uses_kernel


def test_compare_with_xla_on_reference_is_clean():
    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec, n=20)
    deltas, log_u = _rounds_inputs(4, rr=12)
    res = G.compare_with_xla(spec, x, y, jnp.asarray(0.3), jnp.zeros(4),
                             deltas, log_u, theta1_prior=p1,
                             theta2_prior=p2, jitter=1e-8,
                             impl=G.reference_rounds)
    assert res["candidates"] == 48 and res["finite"] == 48
    assert res["val_err"] < 1e-8 and res["beta_err"] < 1e-8
    assert res["finite_mismatch"] == 0 and res["clear_flips"] == 0


def test_chunked_chain_through_wrapper_equals_scan(monkeypatch):
    """A whole speculative chain through the chunked driver gives the
    same records whether each chunk runs the XLA scan or the kernel's
    wrapper (over its plain reference) — the driver-level contract."""
    from ccgp_tpu.infer.metropolis import metropolis

    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec, n=12)
    kw = dict(theta1_prior=p1, theta2_prior=p2, jitter=1e-8)
    s2 = jnp.asarray(0.3)
    lp = make_logpost(spec, x, y, s2, **kw)
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    run = dict(n_max=200, samp_size=60, batch_size=20, speculative=4,
               rounds_per_call=8, rounds_per_call_warm=24)
    want = metropolis(lp, start, jax.random.PRNGKey(4),
                      mh_rounds=make_mh_rounds(spec, x, y, s2, **kw), **run)
    monkeypatch.setattr(G, "use_kernel",
                        lambda *a: G.in_envelope(a[0], *a[1:4],
                                                 jnp.float32))
    monkeypatch.setattr(G, "_ffi_rounds", G.reference_rounds)
    got = metropolis(lp, start, jax.random.PRNGKey(4),
                     mh_rounds=make_mh_rounds(spec, x, y, s2, **kw), **run)
    n = int(want.n_recorded)
    assert int(got.n_recorded) == n and n > 60
    assert int(got.n_proposals) == int(want.n_proposals)
    assert np.allclose(np.asarray(got.samples[:n]),
                       np.asarray(want.samples[:n]), atol=1e-9)
    assert np.allclose(np.asarray(got.logposts[:n]),
                       np.asarray(want.logposts[:n]), atol=1e-8)


def test_compare_with_xla_catches_a_wrong_kernel():
    """The kernel check fails a kernel whose prior term is off: the
    checker itself is not a tautology."""
    spec, p1, p2, pp = CONFIGS["aniso-tied-ln-ig"]
    x, y = _problem(spec, n=20)
    deltas, log_u = _rounds_inputs(4, rr=12)

    def wrong(*a, **kw):
        return G.reference_rounds(*a, **dict(kw, prior2=0))   # drop IG(3,4)

    res = G.compare_with_xla(spec, x, y, jnp.asarray(0.3), jnp.zeros(4),
                             deltas, log_u, theta1_prior=p1,
                             theta2_prior=p2, jitter=1e-8, impl=wrong)
    assert res["val_err"] > 1e-3


def test_build_library_reports_compiler_failure(monkeypatch, tmp_path):
    monkeypatch.setattr(G, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(G, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        G.build_library()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.gpu
def test_kernel_matches_xla_on_gpu(gpu_device):
    """The compiled kernel against the XLA scan at the flagship shape
    (chip_smoke.py's kernel phase runs this same check on the card)."""
    from ccgp_tpu.experiments import flagship

    res = flagship.kernel_check(n=100)
    assert res["ok"], res
