import numpy as np

from ccgp_tpu.eval.compare import ModelPrediction
from ccgp_tpu.eval.datasets import load_gv_archived_results
from ccgp_tpu.eval.plots import (
    plot_gp_1d, plot_gp_2d, prior_posterior_plot, mcmc_diagnostics_plot,
    predicted_vs_true_plot,
)
from ccgp_tpu.eval.results import (
    write_comparison_table, read_comparison_table, summary_from_table,
)
from ccgp_tpu.models.priors import InverseGamma
from ccgp_tpu.utils.progress import progress, stage_timer


def test_plots_render(tmp_path, rng):
    x = np.linspace(0, 1, 30)
    y = np.sin(10 * x)
    fig = plot_gp_1d(x, y, y + 0.01, y - 0.2, y + 0.2, single_mean=y,
                     x_train=x[::5], y_train=y[::5], title="t")
    fig.savefig(tmp_path / "p1.png")
    xy = rng.uniform(size=(50, 2))
    z = np.sin(xy[:, 0] * 5)
    fig = plot_gp_2d(xy, z, z - 0.2, z + 0.2, xy[:5], z[:5])
    fig.savefig(tmp_path / "p2.png")
    fig = prior_posterior_plot(rng.uniform(0.2, 0.9, 500),
                               rng.gamma(2, 0.5, 500),
                               rng.gamma(5, 3, 500),
                               InverseGamma(3, 2), InverseGamma(5, 16))
    fig.savefig(tmp_path / "p3.png")
    fig = mcmc_diagnostics_plot(rng.normal(size=(400, 3)),
                                ["log t1", "log t2", "logit p"])
    fig.savefig(tmp_path / "p4.png")
    fig = predicted_vs_true_plot(y, y + rng.normal(0, 0.05, 30))
    fig.savefig(tmp_path / "p5.png")
    for p in ["p1", "p2", "p3", "p4", "p5"]:
        assert (tmp_path / f"{p}.png").stat().st_size > 1000


def test_results_roundtrip(tmp_path, rng):
    n = 20
    x = rng.uniform(size=(n, 2))
    y = rng.normal(size=n)
    preds = {
        "combined": ModelPrediction(y + 0.1, y - 1, y + 1,
                                    rng.uniform(size=n)),
        "single": ModelPrediction(y + 0.2, y - 2, y + 2),
        "cgp": ModelPrediction(y + 0.3, y - 3, y + 3),
    }
    path = tmp_path / "Results" / "Size 20 Results 1.txt"
    write_comparison_table(path, x, ["x1", "x2"], preds, y)
    cols, tab = read_comparison_table(path)
    assert tab.shape == (n, len(cols) - 0)
    assert "y.hat.Combined" in cols and "Quant.Combined" in cols
    s = summary_from_table(path)
    assert np.isclose(s.rmspe["combined"], 0.1, atol=1e-12)
    assert s.coverage["cgp"] == 1.0


def test_summary_from_archived_reference_table(reference_data):
    """Our reader + summary consume the reference's own archived table."""
    import ccgp_tpu.eval.datasets as ds
    root = ds.data_root()
    path = (root / "Ground Vibrations Emulator" / "Results"
            / "Size 50 Results 1.txt")
    s = summary_from_table(path)
    assert np.isclose(s.rmspe["combined"], 2.722, atol=2e-3)
    assert np.isclose(s.coverage["combined"], 0.973, atol=1e-3)


def test_progress_and_timer(capsys):
    sink = {}
    with stage_timer("stage", sink):
        sum(range(1000))
    assert "stage" in sink and sink["stage"] >= 0
    out = list(progress(range(5), label="t "))
    assert out == [0, 1, 2, 3, 4]
