"""The one compile-cache helper (utils/cache.py): JAX_COMPILATION_CACHE_DIR
when set, with nothing set in code, else the fixed <checkout>/.jax_cache."""

import json
import os
import subprocess
import sys

import pytest

from dvo_tpu.utils import cache

_PROBE = """
import json, os, jax, jax.numpy as jnp
from dvo_tpu.utils.cache import setup_compile_cache
used = setup_compile_cache()
jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()
print(json.dumps({"used": used,
                  "config": jax.config.jax_compilation_cache_dir,
                  "min_secs": jax.config.jax_persistent_cache_min_compile_time_secs}))
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_dir(env_set, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != cache.ENV_VAR}
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(cache.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [checkout] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    target = str(tmp_path / "cache")
    if env_set:
        env[cache.ENV_VAR] = target
        # Cache even this tiny program, so the test can see it written.
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
        env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120, check=True,
    )
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if env_set:
        assert got["used"] == target and got["config"] == target
        # Nothing set in code: JAX's own reading of the environment holds.
        assert got["min_secs"] == 0
        assert os.listdir(target), "no cache entry written to the env dir"
    else:
        assert got["used"] == got["config"] == cache.DEFAULT_DIR
        assert cache.DEFAULT_DIR.endswith(os.sep + ".jax_cache")
        assert not os.path.exists(target)
