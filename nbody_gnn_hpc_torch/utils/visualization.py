"""Plots of trajectories, predictions and training (port of
``nbody_gnn_hpc_tpu/utils/visualization.py``).

Parity target: ``Visualizer`` (reference ``src/utils/visualization.py:
14-360``): the same seven plot types with the same signatures and file
names, so evaluation artifacts look identical: trajectory 3D, HPC-vs-AI
comparison triptych, error over time, training history (log loss + LR),
energy conservation, particle-motion animation, position histograms.
Arrays are numpy arrays or tensors on any device (read back to the host).

Host work only.  Matplotlib is imported lazily and headless (Agg), so the
compute path never depends on it or on a display.
"""

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _host(a):
    """A numpy view of a tensor on any device, or ``a`` as an array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class Visualizer:
    """Plotting tools for simulations and AI predictions."""

    def __init__(self, output_dir: str = "./results/plots"):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        plt = _plt()
        try:
            plt.style.use("seaborn-v0_8-darkgrid")
        except OSError:
            pass  # style optional; keep default if seaborn styles absent
        self.colors = plt.cm.viridis(np.linspace(0, 1, 10))

    def _finish(self, fig, save_name, show):
        plt = _plt()
        if save_name:
            fig.savefig(self.output_dir / save_name, dpi=150,
                        bbox_inches="tight")
        if show:
            plt.show()
        return fig

    def plot_trajectory_3d(self, positions: np.ndarray,
                           title: str = "N-Body Trajectory",
                           particle_indices: Optional[List[int]] = None,
                           save_name: Optional[str] = None,
                           show: bool = True):
        """3D particle paths with start (o) / end (x) markers
        (parity: visualization.py:33-85)."""
        positions = _host(positions)
        plt = _plt()
        fig = plt.figure(figsize=(12, 10))
        ax = fig.add_subplot(111, projection="3d")
        n_particles = positions.shape[1]
        if particle_indices is None:
            particle_indices = range(min(n_particles, 50))
        colors = plt.cm.rainbow(np.linspace(0, 1, len(particle_indices)))
        for i, idx in enumerate(particle_indices):
            ax.plot(positions[:, idx, 0], positions[:, idx, 1],
                    positions[:, idx, 2], color=colors[i], alpha=0.7,
                    linewidth=0.5)
            ax.scatter(*positions[0, idx], color=colors[i], s=30, marker="o")
            ax.scatter(*positions[-1, idx], color=colors[i], s=30, marker="x")
        ax.set_xlabel("X"), ax.set_ylabel("Y"), ax.set_zlabel("Z")
        ax.set_title(title)
        return self._finish(fig, save_name, show)

    def plot_comparison(self, hpc_positions: np.ndarray,
                        ai_positions: np.ndarray,
                        title: str = "HPC vs AI Prediction",
                        particle_indices: Optional[List[int]] = None,
                        save_name: Optional[str] = None, show: bool = True):
        """Triptych: HPC / AI / overlay (parity: visualization.py:87-154)."""
        hpc_positions, ai_positions = _host(hpc_positions), _host(ai_positions)
        plt = _plt()
        fig = plt.figure(figsize=(16, 6))
        ax1 = fig.add_subplot(131, projection="3d")
        ax1.set_title("HPC Ground Truth")
        ax2 = fig.add_subplot(132, projection="3d")
        ax2.set_title("AI Prediction")
        ax3 = fig.add_subplot(133, projection="3d")
        ax3.set_title("Overlay (HPC=solid, AI=dashed)")

        n_particles = hpc_positions.shape[1]
        if particle_indices is None:
            particle_indices = range(min(n_particles, 20))
        colors = plt.cm.rainbow(np.linspace(0, 1, len(particle_indices)))

        for i, idx in enumerate(particle_indices):
            for ax, data, style in ((ax1, hpc_positions, "-"),
                                    (ax2, ai_positions, "-"),
                                    (ax3, hpc_positions, "-"),
                                    (ax3, ai_positions, "--")):
                ax.plot(data[:, idx, 0], data[:, idx, 1], data[:, idx, 2],
                        color=colors[i], alpha=0.7, linewidth=0.8,
                        linestyle=style)
        for ax in (ax1, ax2, ax3):
            ax.set_xlabel("X"), ax.set_ylabel("Y"), ax.set_zlabel("Z")
        fig.suptitle(title)
        fig.tight_layout()
        return self._finish(fig, save_name, show)

    def plot_error_over_time(self, position_rmse: np.ndarray,
                             velocity_rmse: np.ndarray,
                             title: str = "Prediction Error Over Time",
                             save_name: Optional[str] = None,
                             show: bool = True):
        """Per-step RMSE panels (parity: visualization.py:156-196)."""
        position_rmse = _host(position_rmse)
        velocity_rmse = _host(velocity_rmse)
        plt = _plt()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
        steps = np.arange(len(position_rmse))
        for ax, series, color, label in (
                (ax1, position_rmse, "b", "Position RMSE"),
                (ax2, velocity_rmse, "r", "Velocity RMSE")):
            ax.plot(steps, series, f"{color}-", linewidth=2, label=label)
            ax.fill_between(steps, 0, series, alpha=0.3)
            ax.set_xlabel("Time Step"), ax.set_ylabel("RMSE")
            ax.set_title(label.split()[0] + " Error")
            ax.legend(), ax.grid(True, alpha=0.3)
        fig.suptitle(title)
        fig.tight_layout()
        return self._finish(fig, save_name, show)

    def plot_training_history(self, history: Dict,
                              title: str = "Training History",
                              save_name: Optional[str] = None,
                              show: bool = True):
        """Loss (log) + LR curves (parity: visualization.py:198-238)."""
        plt = _plt()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
        epochs = range(1, len(history["train_loss"]) + 1)
        ax1.plot(epochs, history["train_loss"], "b-", label="Train Loss",
                 linewidth=2)
        val = history.get("val_loss")
        if val and not all(np.isnan(val)):
            ax1.plot(epochs, val, "r-", label="Val Loss", linewidth=2)
        ax1.set_xlabel("Epoch"), ax1.set_ylabel("Loss")
        ax1.set_title("Loss Curves"), ax1.legend()
        ax1.set_yscale("log"), ax1.grid(True, alpha=0.3)

        ax2.plot(epochs, history["learning_rate"], "g-", linewidth=2)
        ax2.set_xlabel("Epoch"), ax2.set_ylabel("Learning Rate")
        ax2.set_title("Learning Rate Schedule")
        ax2.set_yscale("log"), ax2.grid(True, alpha=0.3)
        fig.suptitle(title)
        fig.tight_layout()
        return self._finish(fig, save_name, show)

    def plot_energy_conservation(self, hpc_energy: np.ndarray,
                                 ai_energy: np.ndarray,
                                 title: str = "Energy Conservation",
                                 save_name: Optional[str] = None,
                                 show: bool = True):
        """Normalized-energy comparison (parity: visualization.py:240-273)."""
        hpc_energy, ai_energy = _host(hpc_energy), _host(ai_energy)
        plt = _plt()
        fig, ax = plt.subplots(figsize=(10, 6))
        steps = np.arange(len(hpc_energy))
        ax.plot(steps, hpc_energy / hpc_energy[0], "b-", linewidth=2,
                label="HPC")
        ax.plot(np.arange(len(ai_energy)), ai_energy / ai_energy[0], "r--",
                linewidth=2, label="AI")
        ax.axhline(y=1.0, color="k", linestyle=":", alpha=0.5,
                   label="Initial")
        ax.set_xlabel("Time Step"), ax.set_ylabel("Normalized Total Energy")
        ax.set_title(title), ax.legend(), ax.grid(True, alpha=0.3)
        return self._finish(fig, save_name, show)

    def create_animation(self, positions: np.ndarray, interval: int = 50,
                         save_name: Optional[str] = None):
        """Particle-motion animation, .gif (pillow) or .mp4 (ffmpeg)
        (parity: visualization.py:275-329)."""
        positions = _host(positions)
        plt = _plt()
        from matplotlib.animation import FuncAnimation

        fig = plt.figure(figsize=(10, 10))
        ax = fig.add_subplot(111, projection="3d")
        n_steps, n_particles, _ = positions.shape

        all_pos = positions.reshape(-1, 3)
        margin = 0.1 * (all_pos.max() - all_pos.min())
        ax.set_xlim(all_pos[:, 0].min() - margin, all_pos[:, 0].max() + margin)
        ax.set_ylim(all_pos[:, 1].min() - margin, all_pos[:, 1].max() + margin)
        ax.set_zlim(all_pos[:, 2].min() - margin, all_pos[:, 2].max() + margin)

        colors = plt.cm.viridis(np.linspace(0, 1, n_particles))
        scatter = ax.scatter(positions[0, :, 0], positions[0, :, 1],
                             positions[0, :, 2], c=colors, s=20)
        title = ax.set_title("Step 0")

        def update(frame):
            scatter._offsets3d = (positions[frame, :, 0],
                                  positions[frame, :, 1],
                                  positions[frame, :, 2])
            title.set_text(f"Step {frame}")
            return scatter, title

        anim = FuncAnimation(fig, update, frames=n_steps, interval=interval,
                             blit=False)
        if save_name:
            filepath = self.output_dir / save_name
            writer = "pillow" if str(save_name).endswith(".gif") else "ffmpeg"
            anim.save(filepath, writer=writer, fps=1000 // interval)
            print(f"Saved animation to {filepath}")
        return anim

    def plot_particle_distribution(self, positions: np.ndarray,
                                   step: int = -1,
                                   title: str = "Particle Distribution",
                                   save_name: Optional[str] = None,
                                   show: bool = True):
        """Per-axis position histograms (parity: visualization.py:331-360)."""
        positions = _host(positions)
        plt = _plt()
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        pos = positions[step]
        for i, (ax, label) in enumerate(zip(axes, ["X", "Y", "Z"])):
            ax.hist(pos[:, i], bins=30, alpha=0.7, color=self.colors[i])
            ax.set_xlabel(f"{label} Position"), ax.set_ylabel("Count")
            ax.set_title(f"{label} Distribution")
        fig.suptitle(title)
        fig.tight_layout()
        return self._finish(fig, save_name, show)
