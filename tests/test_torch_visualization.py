"""The port's Visualizer (nbody_gnn_hpc_torch/utils/visualization.py)
against the JAX package's, on the CPU (Agg): every method renders, and
the five static plots decode to the same pixels as the JAX package's on
the same arrays (and on tensors of them)."""

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from nbody_gnn_hpc_torch.utils import Visualizer  # noqa: E402
from nbody_gnn_hpc_tpu.utils.visualization import \
    Visualizer as JaxVisualizer  # noqa: E402


@pytest.fixture
def dirs(tmp_path):
    yield tmp_path / "jax", tmp_path / "port"
    plt.close("all")


def _inputs():
    r = np.random.RandomState(0)
    traj = np.cumsum(r.randn(20, 8, 3), axis=0)
    energy = 1e18 * (1 + 0.01 * r.randn(40))
    return {
        "plot_trajectory_3d": ((traj,), {}),
        "plot_comparison": ((traj, traj + 0.1), {}),
        "plot_error_over_time": ((np.abs(r.randn(30)),
                                  np.abs(r.randn(30))), {}),
        "plot_training_history": (({"train_loss": [3.0, 2.0, 1.5],
                                    "val_loss": [2.5, 2.0, 1.8],
                                    "learning_rate": [5e-4, 4e-4, 3e-4]},),
                                  {}),
        "plot_energy_conservation": ((energy, energy * 1.01), {}),
        "plot_particle_distribution": ((traj,), {"step": -1}),
    }


STATIC = sorted(_inputs())


def _tensors(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.mark.parametrize("method", STATIC)
def test_static_plot_pixels_equal_jax(dirs, method):
    jdir, pdir = dirs
    args, kw = _inputs()[method]
    getattr(JaxVisualizer(str(jdir)), method)(*args, save_name="p.png",
                                             show=False, **kw)
    port = Visualizer(str(pdir))
    getattr(port, method)(*args, save_name="p.png", show=False, **kw)
    getattr(port, method)(*_tensors(args), save_name="t.png", show=False,
                          **kw)
    want = mpimg.imread(jdir / "p.png")
    assert want.size > 0 and (pdir / "p.png").stat().st_size > 0
    np.testing.assert_array_equal(mpimg.imread(pdir / "p.png"), want)
    np.testing.assert_array_equal(mpimg.imread(pdir / "t.png"), want)


def test_create_animation(dirs):
    _, pdir = dirs
    traj = _inputs()["plot_trajectory_3d"][0][0]
    Visualizer(str(pdir)).create_animation(torch.from_numpy(traj[:5]),
                                           save_name="a.gif")
    assert (pdir / "a.gif").stat().st_size > 0


def test_visualizer_is_lazy():
    """Importing the utilities does not import matplotlib's pyplot."""
    import subprocess
    import sys

    code = ("import sys, nbody_gnn_hpc_torch.utils as u\n"
            "assert 'matplotlib.pyplot' not in sys.modules\n"
            "assert u.Visualizer.__name__ == 'Visualizer'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
