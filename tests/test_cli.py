"""The CLI's main path on the card's kind of host: no PIL and no native
library (libpng absent), so PNGs go through the numpy + zlib decoder.
Runs ``dvo_tpu.run.main`` in a fresh process on small generated
sequences."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = """
import json, sys
sys.modules["PIL"] = None          # any PIL import now fails
from dvo_tpu import native

def unavailable():
    raise native.NativeUnavailable("libpng absent")

native.load_library = unavailable
from dvo_tpu.run import main
main(json.loads(sys.argv[1]))
assert "PIL" not in {m.split(".")[0] for m in sys.modules if sys.modules[m]}
"""


@pytest.mark.parametrize("mode", ["mono", "rgbd"])
def test_cli_without_pil_or_native(mode, tmp_path):
    from dvo_tpu.utils import synth

    small = dict(size=(160, 120))
    if mode == "mono":
        data = synth.write_info_sequence(
            str(tmp_path / "seq"), 6, K=synth.LOGICOOL_K / [[4], [4], [1]], **small
        )
        argv = ["--data", data]
    else:
        data = synth.write_tum_sequence(
            str(tmp_path / "seq"), 6, K=synth.TUM_K / [[4], [4], [1]], **small
        )
        argv = ["--data", data, "--format", "tum", "--mode", "rgbd"]
    argv += ["--calib", os.path.join(data, "calib.yaml"), "--chunk", "4",
             "--gt", os.path.join(data, "groundtruth.txt"),
             "--out", str(tmp_path / "traj.txt"), "--platform", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _DRIVER, json.dumps(argv)], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["frames"] == 6
    assert report["device"] == {"platform": "cpu", "kind": "cpu"}
    assert report["ate_rmse_m"] < 0.05
