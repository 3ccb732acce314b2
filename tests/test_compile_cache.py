"""Where the persistent XLA compile cache goes (utils/compilecache.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as it is; otherwise the
    cache sits at <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax, metagenome_vector_sketches_tpu.ops.pairwise; "
            "print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-500:]
    want = str(tmp_path / env_dir) if env_dir else \
        os.path.join(REPO, ".jax_cache")
    assert p.stdout.strip().splitlines()[-1] == want
