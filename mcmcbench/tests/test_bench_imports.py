"""No module the harness loads is JAX's or the JAX package's (top-level
names compared whole), and the run refuses without a card."""
import os
import shutil
import subprocess
import sys

from mcmcbench.lib import env
from mcmcbench.tests.tiny import ROOT


def test_forbidden_names_compare_the_top_level_name_whole():
    assert env.forbidden_loaded(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert env.forbidden_loaded(["repro.core", "jax.numpy", "jaxlib", "flax", "benchmarks.x",
                                 "reprox"]) == ["benchmarks.x", "flax", "jax.numpy", "jaxlib",
                                                "repro.core"]


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from mcmcbench.lib import env, harness\n"
        "from mcmcbench.tests import tiny\n"
        "for cell in (tiny.lm_cell(), tiny.lr_cell()):\n"
        "    harness.run_cell(cell, 5, 0.2, True, torch.device('cpu'), time.monotonic())\n"
        "print('FORBIDDEN', env.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def _run(cwd):
    env_vars = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "mcmcbench/run.py", "--workload",
                           "bayeslr-mnist.masked-k1024", "--seed", "2147483700", "--seconds",
                           "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=cwd, env=env_vars)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mcmcbench", tmp_path / "mcmcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
