"""Test harness: force JAX onto CPU with 8 virtual devices so sharding
tests run without several cards (SURVEY.md §4 implication), set before jax
import.  Everything that needs a GPU is a phase of ``chip_smoke.py``."""

import os

# Force CPU, also on a machine with a GPU: the tests run on the virtual
# 8-device CPU mesh.  The config update after import makes sure of it.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: the suite's cost is dominated by XLA:CPU
# compiles of full-pipeline programs at many distinct shapes.  Caching them
# on disk makes repeat runs several times faster.
from dvo_tpu.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def synth_mono_seq(tmp_path_factory):
    """12 frames of the generated 640x480 monocular info.txt sequence."""
    from dvo_tpu.utils import synth

    return synth.write_info_sequence(str(tmp_path_factory.mktemp("mono")), 12)


@pytest.fixture(scope="session")
def synth_kinect_seq(tmp_path_factory):
    """3 frames of the generated Kinect v2 rig sequence."""
    from dvo_tpu.utils import synth
    from dvo_tpu.utils.datasets import KinectCalibration

    return synth.write_kinect_sequence(
        str(tmp_path_factory.mktemp("kinect")), 3, KinectCalibration.kinect_v2()
    )
