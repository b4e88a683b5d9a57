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
