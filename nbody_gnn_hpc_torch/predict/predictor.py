"""Inference engine: single-step predict and rollouts on the device.

Port of ``nbody_gnn_hpc_tpu/predict/predictor.py`` (reference
``src/ai/predict.py:20-194``): normalise -> k-NN graph on the device ->
forward -> denormalise, outputs fed back in physical units.  The JAX
package compiles the rollout into one ``lax.scan``; here it is a Python
loop over steps whose tensors never leave the device until the end.

Weight-only quantization (:mod:`~nbody_gnn_hpc_torch.predict.quantize`):
after :meth:`Predictor.quantize`, or loading a checkpoint that carries the
``"quantization"`` marker, the quantized parameter tree is what stays on
the device (the model's float32 kernels are released), and every rollout
call dequantizes it to float32 once, before its first step.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import resolve_device, use_full_f32
from nbody_gnn_hpc_torch.io.model_io import load_checkpoint, load_into
from nbody_gnn_hpc_torch.io.model_io import params_from_jax, params_to_jax
from nbody_gnn_hpc_torch.models.gnn import NBodyGNN
from nbody_gnn_hpc_torch.ops.knn import (fully_connected_edge_index,
                                         knn_edge_index)
from nbody_gnn_hpc_torch.utils.profiling import annotate


class Predictor:
    """Rollout engine for a trained N-body GNN.

    ``device``: ``cuda`` by default; ``"cpu"`` only when asked for.
    """

    def __init__(self, model: NBodyGNN, model_path: Optional[str] = None,
                 device=None, k_neighbors: Optional[int] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model = model.to(self.device).eval()
        self.k_neighbors = k_neighbors
        self.norm_stats = None
        self.quantization = None  # None | "bf16" | "int8" (weight-only)
        self._quantized = None    # the quantized parameter tree, on device
        self._released = []       # (parameter, shape) of released kernels
        if model_path:
            self.load_model(model_path)

    def load_model(self, model_path: str) -> None:
        """Load params + normalisation stats (``predict.py:40-52``; the
        stats are load-bearing for correctness).  A quantized serving
        checkpoint is checked against the model's names and shapes, then
        kept quantized."""
        from nbody_gnn_hpc_torch.predict.quantize import tree_to_device

        ckpt = load_checkpoint(model_path)
        self.quantization, self._quantized = None, None
        for p, shape in self._released:  # by an earlier quantization
            p.data = p.data.new_empty(shape)
        self._released = []
        self.norm_stats = load_into(self.model, ckpt)
        if ckpt.get("quantization"):
            self._hold_quantized(
                tree_to_device(ckpt["model_state_dict"], self.device),
                ckpt["quantization"])
        if self.norm_stats is not None:
            print("Loaded normalization stats")
        tag = f" [{self.quantization} weights]" if self.quantization else ""
        print(f"Loaded model from {model_path}{tag}")

    def quantize(self, mode: str) -> None:
        """Quantize the loaded weights in place (weight-only, ``"bf16"`` or
        ``"int8"``): a serving memory knob, no reload."""
        from nbody_gnn_hpc_torch.predict.quantize import quantize_params

        if self.quantization:
            raise ValueError(f"params already {self.quantization}-quantized")
        tree = params_to_jax(self.model.state_dict(), numpy=False)
        self._hold_quantized(quantize_params(tree, mode), mode)

    def _hold_quantized(self, tree, mode: str) -> None:
        """Keep ``tree`` as the weights and release the float32 kernels it
        replaces (the model keeps their names; its state dict is no longer
        a checkpoint)."""
        self._quantized, self.quantization = tree, mode
        for p in self.model.parameters():
            if p.dim() >= 2:
                self._released.append((p, p.shape))
                p.data = p.data.new_empty(0)

    def _forward_fn(self):
        """The model's forward for one rollout call: with quantized weights,
        through a float32 state dict dequantized here, once."""
        if self._quantized is None:
            return self.model
        from nbody_gnn_hpc_torch.predict.quantize import dequantize_params

        weights = params_from_jax(dequantize_params(self._quantized))
        return lambda *args: torch.func.functional_call(self.model, weights,
                                                        args)

    def _mean_std(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.norm_stats is None:
            return (torch.zeros(6, device=self.device),
                    torch.ones(6, device=self.device))
        return tuple(torch.as_tensor(self.norm_stats[k], dtype=torch.float32,
                                     device=self.device)
                     for k in ("state_mean", "state_std"))

    @torch.inference_mode()
    def _rollout(self, pos0, vel0, masses, n_steps: int, trajectory: bool):
        """Roll (N, 3) or (B, N, 3) states forward. ``masses`` (N,) or
        (B, N): each system's mass feature is normalised by its own mean.
        Returns device tensors (..., n_steps+1, N, 3), or the final
        (..., N, 3) states when ``trajectory`` is False."""
        masses = np.asarray(masses)
        mass_feat = (masses / masses.mean(axis=-1, keepdims=True)
                     )[..., None].astype(np.float32)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        pos, vel, mass_feat = as_dev(pos0), as_dev(vel0), as_dev(mass_feat)
        mass_feat = mass_feat.expand(*pos.shape[:-1], 1)
        mean, std = self._mean_std()
        n = pos.shape[-2]
        k = self.k_neighbors
        use_knn = k is not None and k < n - 1
        static_edges = None if use_knn else torch.as_tensor(
            fully_connected_edge_index(n), device=self.device)
        forward = self._forward_fn()
        ps, vs = [pos], [vel]
        for _ in range(n_steps):
            with annotate("predict.step"):
                norm_pos = (pos - mean[:3]) / std[:3]
                norm_vel = (vel - mean[3:6]) / std[3:6]
                x = torch.cat([norm_pos, norm_vel, mass_feat], dim=-1)
                with annotate("predict.knn"):
                    edges = knn_edge_index(norm_pos, k) if use_knn \
                        else static_edges
                with annotate("predict.forward"):
                    pred = forward(x, edges, norm_pos)
                pos = pred[..., :3] * std[:3] + mean[:3]
                vel = pred[..., 3:6] * std[3:6] + mean[3:6]
            if trajectory:
                ps.append(pos)
                vs.append(vel)
        if not trajectory:
            return pos, vel
        return torch.stack(ps, dim=-3), torch.stack(vs, dim=-3)

    def predict_single(self, positions: np.ndarray, velocities: np.ndarray,
                       masses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Next state in physical units (``predict.py:93-117``)."""
        pos, vel = self._rollout(positions, velocities, masses, 1, False)
        return pos.cpu().numpy(), vel.cpu().numpy()

    def predict_rollout(self, initial_positions: np.ndarray,
                        initial_velocities: np.ndarray,
                        masses: np.ndarray, n_steps: int,
                        trajectory: bool = True,
                        out_dtype=np.float64) -> Dict[str, np.ndarray]:
        """Multi-step rollout (``predict.py:119-154``).

        ``trajectory=False`` returns the final (N, 3) state only, so
        nothing per-step is kept or copied to the host.  ``out_dtype`` is
        the host dtype of the result: float64 is the reference's
        convention; serving passes float32 (the compute dtype)."""
        ps, vs = self._rollout(initial_positions, initial_velocities,
                               masses, int(n_steps), trajectory)
        with annotate("predict.readback"):
            ps = ps.cpu().numpy().astype(out_dtype, copy=False)
            vs = vs.cpu().numpy().astype(out_dtype, copy=False)
        return {"positions": ps, "velocities": vs,
                "n_steps": int(n_steps),
                "n_particles": len(masses) if np.ndim(masses) == 1
                else np.shape(masses)[-1]}

    def predict_rollout_batch(self, initial_positions: np.ndarray,
                              initial_velocities: np.ndarray,
                              masses: np.ndarray, n_steps: int,
                              trajectory: bool = True,
                              out_dtype=np.float64
                              ) -> Dict[str, np.ndarray]:
        """Rollouts of a batch of (B, N, 3) states at once, one k-NN graph
        per system per step; outputs (B, n_steps+1, N, 3), or (B, N, 3)
        with ``trajectory=False``.  ``masses``: (N,) shared or (B, N) per
        system, each normalised by its own mean."""
        if np.ndim(initial_positions) != 3:
            raise ValueError("predict_rollout_batch takes (B, N, 3) states, "
                             f"got shape {np.shape(initial_positions)}")
        return self.predict_rollout(initial_positions, initial_velocities,
                                    masses, n_steps, trajectory, out_dtype)


def compare_with_hpc(predictor: Predictor, hpc_trajectory: Dict,
                     start_step: int = 0,
                     n_prediction_steps: int = 100) -> Dict:
    """Roll the GNN out from a ground-truth state and score per-step RMSE
    (``predict.py:157-194``)."""
    positions = hpc_trajectory["positions"]
    velocities = hpc_trajectory["velocities"]
    masses = hpc_trajectory["masses"]

    ai = predictor.predict_rollout(positions[start_step],
                                   velocities[start_step],
                                   masses, n_prediction_steps)

    end_step = min(start_step + n_prediction_steps + 1, len(positions))
    hpc_pos = positions[start_step:end_step]
    hpc_vel = velocities[start_step:end_step]
    ai_pos = ai["positions"][:len(hpc_pos)]
    ai_vel = ai["velocities"][:len(hpc_vel)]

    pos_error = np.sqrt(np.mean((ai_pos - hpc_pos) ** 2, axis=(1, 2)))
    vel_error = np.sqrt(np.mean((ai_vel - hpc_vel) ** 2, axis=(1, 2)))

    return {
        "ai_positions": ai_pos,
        "ai_velocities": ai_vel,
        "hpc_positions": hpc_pos,
        "hpc_velocities": hpc_vel,
        "position_rmse": pos_error,
        "velocity_rmse": vel_error,
        "mean_position_rmse": float(np.mean(pos_error)),
        "mean_velocity_rmse": float(np.mean(vel_error)),
        "final_position_rmse": float(pos_error[-1]),
        "final_velocity_rmse": float(vel_error[-1]),
    }
