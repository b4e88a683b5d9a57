"""The port's large-N pipeline (nbody_gnn_hpc_torch/largen_pipeline.py)
against ``scripts/largen_pipeline.sh``, on the CPU: the scales and each
stage's flags are the script's, and ``run_scale`` runs the three stages as
processes at a tiny N, the model shrunk by stage flags, printing the
script's ``STAGE_WALL`` and ``LARGEN_RESULT`` lines."""

import math
import re
import shlex
from pathlib import Path

import pytest

from nbody_gnn_hpc_torch import largen_pipeline as lp

REPO = Path(__file__).resolve().parent.parent
SCRIPT = (REPO / "scripts" / "largen_pipeline.sh").read_text()


def _script_commands(scale) -> list:
    """(command, argv) of the script's three stages with ``run_scale``'s
    variables of ``scale`` filled in."""
    names = ("N", "SIMS", "STEPS", "EPOCHS", "BATCH", "TESTS")
    text = SCRIPT.replace("\\\n", " ")
    for name, value in zip(names, scale):
        text = text.replace(f'"${name}"', str(value))
    cmds = re.findall(r'python "\$REPO/scripts/(\w+)\.py" ([^\n]*)', text)
    return [(cmd, shlex.split(rest)) for cmd, rest in cmds]


def test_scales_are_the_scripts():
    calls = re.findall(r"^run_scale ([\d ]+)$", SCRIPT, re.M)
    assert [tuple(map(int, c.split())) for c in calls] == list(lp.SCALES)


@pytest.mark.parametrize("scale", lp.SCALES, ids=lambda s: f"n{s[0]}")
def test_stage_flags_are_the_scripts(scale):
    """HDF5: the script's argv, command for command; npz swaps the
    compression for the manifest and the npz store."""
    want = _script_commands(scale)
    got = lp.stage_argvs(*scale, "h5")
    assert [(a[0], a[1:]) for _, _, a in got] == want
    npz = lp.stage_argvs(*scale, "npz")
    datagen = npz[0][2]
    assert "--compression" not in datagen
    assert datagen[datagen.index("--no-windows"):][:3] == [
        "--no-windows", "--trajectory-format", "npz"]
    assert [a for _, _, a in npz[1:]] == [a for _, _, a in got[1:]]


def test_run_scale_at_a_tiny_size(tmp_path, capsys):
    """N=13, 3 sims x 12 steps, one epoch at hidden 16, one layer, k=4, on
    the npz store: every stage exits 0 in ``<workdir>/n13`` and the
    metrics are finite."""
    shrink = {"train_model": {"--hidden-dim": "16", "--n-layers": "1",
                              "--k-neighbors": "4"}}
    result = lp.run_scale(tmp_path, 13, 3, 12, 1, 2, 1,
                          trajectory_format="npz", device="cpu",
                          values=shrink)
    out = capsys.readouterr().out
    walls = re.findall(r"^STAGE_WALL (\w+) n=13 (\d+\.\d) s$", out, re.M)
    assert [w[0] for w in walls] == ["datagen", "train", "evaluate"]
    train = shlex.split(re.search(r"^Running: (.*train_model.*)$", out,
                                  re.M).group(1))
    for flag, value in shrink["train_model"].items():
        assert train[train.index(flag) + 1] == value
    line = re.search(r"^LARGEN_RESULT n=13 posRMSE=(\S+) velRMSE=(\S+) "
                     r"energy_err=(\S+)$", out, re.M)
    assert line is not None
    assert all(math.isfinite(float(v)) for v in line.groups())
    assert float(line.group(1)) == result["metrics"]["position_rmse"]
    assert set(result["walls"]) == set(result["launches"]) == {
        "datagen", "train", "evaluate"}
    assert all(v == 0 for c in result["launches"].values()
               for v in c.values())  # the CPU launches no kernel
    root = tmp_path / "n13"
    assert len(list((root / "data" / "checkpoints").glob(
        "sim_*_trajectory.npz"))) == 3
    assert (root / "data" / "dataset_manifest.json").exists()
    assert (root / "models" / "best_model.pt").exists()
