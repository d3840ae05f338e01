"""chip_smoke.py's comparison and reporting code, on the CPU at small sizes.
The script itself runs only on a GPU; here it must refuse to."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    if where == "checkout":
        script, cwd = os.path.join(ROOT, "chip_smoke.py"), ROOT
    else:   # a directory holding chip_smoke.py and nothing else of the repo
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    out = _run_script(script, cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout, out.stdout


def test_comparison_helpers():
    a = np.array([[1.0, 2.0], [3.0, 4.0]])
    assert chip_smoke.rel_err(a, a) == 0.0
    assert chip_smoke.rel_err(a * (1 + 1e-6), a) == pytest.approx(1e-6, rel=1e-3)
    assert chip_smoke.count_rel(1005, 1000) == pytest.approx(0.005)
    assert chip_smoke.count_rel(0, 0) == 0.0
    old = np.zeros(6)
    new = np.array([0.0, 1.0, 2.0, 3.0, 0.0, 5.0])
    ref = np.array([0.0, 1.0, 2.0, 3.5, 4.0, 0.0])
    # Written on both sides: pixels 1, 2, 3; pixel 3 disagrees.
    share, n = chip_smoke.written_agreement(new, old, ref, old, 1e-4)
    assert n == 3 and share == pytest.approx(2 / 3)
    assert chip_smoke.written_agreement(old, old, old, old, 1e-4) == (1.0, 0)


def test_trajectory_and_twists(tmp_path):
    from dvo_tpu.utils import oracle, synth
    from dvo_tpu.utils.trajectory import write_tum

    gt = synth.ground_truth(synth.camera_path(5))
    p = str(tmp_path / "t.txt")
    write_tum(p, np.arange(5.0), gt)
    ts, poses = chip_smoke.read_trajectory(p)
    np.testing.assert_allclose(ts, np.arange(5.0))
    np.testing.assert_allclose(poses, gt, atol=1e-5)
    tw = chip_smoke.frame_twists(poses)
    step = oracle.se3_log(gt[1])
    assert tw.shape == (4, 6)
    np.testing.assert_allclose(tw, np.tile(step, (4, 1)), atol=1e-5)


def test_pose_graph_cost_parse():
    text = ("frame    1 kf=False acc=    0\n"
            "pose-graph: 9 nodes, 14 edges (2 closures), cost 4.042e-03 -> 9.217e-04\n"
            '{"frames": 48}\n')
    assert chip_smoke.pose_graph_costs(text) == (4.042e-03, 9.217e-04)
    assert chip_smoke.pose_graph_costs('{"frames": 48}') is None


def test_run_phase_reports(capsys):
    assert chip_smoke.run_phase("good", lambda: ({"x": 1}, []))
    assert not chip_smoke.run_phase("bad", lambda: ({"x": 2}, ["x"]))

    def boom():
        raise ValueError("broken")

    assert not chip_smoke.run_phase("raises", boom)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(d["phase"], d["ok"]) for d in lines] == [
        ("good", True), ("bad", False), ("raises", False)]
    assert lines[1]["failed"] == ["x"]
    assert "ValueError: broken" in lines[2]["error"]


def test_sites_phase_cpu():
    """The sites phase end to end at half width, CPU against CPU: every
    site runs, compares and passes its tolerance."""
    cpu = jax.devices("cpu")
    fields, failed = chip_smoke.phase_sites(cpu[0], cpu[1], scale=2)
    assert failed == []
    assert fields["gn_256x212"]["size"] == [128, 106]
    assert fields["depth_update"]["written_both"] > 0
    assert fields["propagate"]["bit_identical"]
    assert set(fields["tolerances"]) >= {"gn_rel", "depth_share"}
