"""Placement of JAX's persistent compilation cache
(qmann_tpu.utils.compile_cache): JAX_COMPILATION_CACHE_DIR when it is set,
else the checkout's .jax_cache/.  Each case runs in a fresh process, since
the cache directory is process-wide JAX configuration."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import os, time
import jax, jax.numpy as jnp
from qmann_tpu.utils.compile_cache import enable_compilation_cache
used = enable_compilation_cache()
assert jax.config.jax_compilation_cache_dir == used, (
    jax.config.jax_compilation_cache_dir, used)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
before = set(os.listdir(used)) if os.path.isdir(used) else set()
# a constant of this run makes the program, and so its entry, new
c = float(time.time_ns() % 10**9)
jax.jit(lambda x: jnp.cumsum(jnp.sin(x) * c))(
    jnp.arange(64, dtype=jnp.float32)).block_until_ready()
print(used)
print(len(set(os.listdir(used)) - before))
"""


def _probe(env_dir, tmp_path):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    used, new_entries = r.stdout.split()
    return used, int(new_entries)


def test_cache_goes_where_the_environment_says(tmp_path):
    target = str(tmp_path / "cache")
    used, new_entries = _probe(target, tmp_path)
    assert used == target
    assert new_entries >= 1
    assert not os.path.exists(tmp_path / ".jax_cache")


def test_cache_defaults_to_the_checkout(tmp_path):
    used, new_entries = _probe(None, tmp_path)
    assert used == os.path.join(REPO, ".jax_cache")
    assert new_entries >= 1
