"""Process set-up: where the compile cache lives, and chip_smoke.py's
refusal to run anywhere but on a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, tuturenderer_tpu as t; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(t.compilation_cache_dir())"],
        cwd=REPO, env=_child_env(**extra), capture_output=True, text=True,
        check=True, timeout=120).stdout.split()
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out == [want, want]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU (and in a directory holding only the script) it exits
    non-zero, names what it found, and prints no result line."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr
    assert '"ok"' not in r.stdout
