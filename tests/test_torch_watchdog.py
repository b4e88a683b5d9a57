"""The port's stall watchdog (nbody_gnn_hpc_torch/utils/watchdog.py), case
for case as tests/test_watchdog.py holds the JAX package's: the primitive
behind ``finetune_rollout --watchdog`` and ``select_checkpoint
--watchdog``."""

import threading
import time

import pytest

from nbody_gnn_hpc_torch.utils.watchdog import (STALL_EXIT_CODE, Watchdog,
                                                maybe_watchdog)


class _ExitRecorder:
    """Injected in place of os._exit so a firing watchdog doesn't kill
    pytest; records the code and lets tests wait on it."""

    def __init__(self):
        self.codes = []
        self.fired = threading.Event()

    def __call__(self, code):
        self.codes.append(code)
        self.fired.set()


def test_fires_on_stall_with_distinctive_code():
    rec = _ExitRecorder()
    with Watchdog(0.15, what="unit-test progress", _exit=rec):
        assert rec.fired.wait(5.0), "watchdog never fired on a stall"
    assert rec.codes[0] == STALL_EXIT_CODE


def test_beats_keep_it_alive():
    rec = _ExitRecorder()
    with Watchdog(0.3, _exit=rec) as wd:
        for _ in range(6):  # 0.6s of runtime, beats every 0.1s < timeout
            time.sleep(0.1)
            wd.beat()
        assert not rec.fired.is_set()


def test_stop_disarms():
    rec = _ExitRecorder()
    wd = Watchdog(0.15, _exit=rec).start()
    wd.stop()
    assert not rec.fired.wait(0.5)


def test_context_exit_disarms_even_on_exception():
    rec = _ExitRecorder()
    with pytest.raises(RuntimeError):
        with Watchdog(0.15, _exit=rec):
            raise RuntimeError("boom")
    assert not rec.fired.wait(0.5)


def test_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        Watchdog(0.0)


def test_maybe_watchdog_cli_semantics():
    """Uniform --watchdog flag semantics across every entry point:
    None/0 -> disabled, positive -> armed, negative -> loud error."""
    assert maybe_watchdog(None) is None
    assert maybe_watchdog(0) is None
    assert maybe_watchdog(0.0) is None
    with pytest.raises(ValueError):
        maybe_watchdog(-5.0)
    wd = maybe_watchdog(60.0, what="unit test")
    try:
        assert isinstance(wd, Watchdog)
        assert wd._thread is not None  # armed, not just constructed
    finally:
        wd.stop()


def test_start_is_idempotent():
    rec = _ExitRecorder()
    wd = Watchdog(10.0, _exit=rec).start()
    assert wd.start() is wd
    assert wd._thread is not None
    wd.stop()


def test_same_exit_code_as_the_jax_package():
    from nbody_gnn_hpc_tpu.utils import watchdog as jax_watchdog

    assert STALL_EXIT_CODE == jax_watchdog.STALL_EXIT_CODE == 117


# -- Trainer.train(watchdog_s=), as nbody_gnn_hpc_tpu/train/trainer.py ----------

def _trainer(tmp_path):
    import numpy as np

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.train import GNNDataset, Trainer

    rng = np.random.RandomState(0)
    trajs = [dict(positions=rng.randn(12, 10, 3).astype(np.float32),
                  velocities=rng.randn(12, 10, 3).astype(np.float32),
                  masses=rng.uniform(1e10, 1e11, 10)) for _ in range(2)]
    ds = GNNDataset.from_trajectories(trajs, sequence_length=3,
                                      k_neighbors=3)
    model = NBodyGNN(hidden_dim=8, n_layers=1, dropout=0.0)
    return Trainer(model, ds, ds, model_dir=str(tmp_path), device="cpu",
                   batch_size=8, noise_std=0.0)


def test_trainer_watchdog_covers_final_saves(tmp_path):
    """Armed through the end-of-training files (saving reads the
    parameters back from the device), disarmed when train() returns; 0 is
    an explicit disable and a negative value a mistake."""
    trainer = _trainer(tmp_path)
    armed_at_final = []
    orig_save = trainer.save_model

    def spying_save(filename):
        if filename == "final_model.pt":
            armed_at_final.append(trainer._watchdog is not None)
        return orig_save(filename)

    trainer.save_model = spying_save
    trainer.train(n_epochs=1, verbose=False, watchdog_s=600.0)
    assert armed_at_final == [True]
    assert trainer._watchdog is None
    trainer.train(n_epochs=1, verbose=False, watchdog_s=0)
    assert armed_at_final == [True, False]
    with pytest.raises(ValueError, match="positive"):
        trainer.train(n_epochs=1, verbose=False, watchdog_s=-1)


def test_trainer_disarms_on_an_exception(tmp_path):
    trainer = _trainer(tmp_path)

    def broken():
        raise RuntimeError("device lost")

    trainer.train_epoch = broken
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train(n_epochs=1, verbose=False, watchdog_s=600.0)
    assert trainer._watchdog is None


STALLED_TRAINING = """
import sys, time
sys.path.insert(0, {tests!r})
from test_torch_watchdog import _trainer
trainer = _trainer({tmp!r})
trainer.train_epoch = lambda: time.sleep(30)  # a device that never returns
trainer.train(n_epochs=1, verbose=False, watchdog_s=0.3)
print("not reached")
"""


def test_stalled_training_exits_with_the_stall_code(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent)
    proc = subprocess.run(
        [sys.executable, "-c", STALLED_TRAINING.format(tests=tests,
                                                       tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=120,
        cwd=Path(tests).parent)
    assert proc.returncode == STALL_EXIT_CODE, proc.stderr[-2000:]
    assert "WATCHDOG: no training-epoch progress" in proc.stderr
    assert "not reached" not in proc.stdout
