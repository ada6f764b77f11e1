from ccgp_tpu.ops.distance import (
    pairwise_sqdist,
    cross_sqdist,
    pairwise_absdiff,
    cross_absdiff,
)
from ccgp_tpu.ops.linalg import (
    jitter_cholesky,
    chol_solve,
    chol_logdet,
    solve_psd,
    logdet_psd,
    tri_solve,
    schur_complement,
    augmented_logdet,
)
from ccgp_tpu.ops.bessel import bessel_kv, log_bessel_kv
from ccgp_tpu.ops import kernels
from ccgp_tpu.ops.special import gammaincinv, invgamma_quantile
from ccgp_tpu.ops.gp import (
    chol_quadratics,
    profile_nll_from_quadratics,
    mvn_nll_from_quadratics,
)
