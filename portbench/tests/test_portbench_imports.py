"""The benchmark measures the port only: no module of JAX or of the JAX
package is loaded, none is imported by its sources, and nothing outside its
own folder and the port is read."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import modcheck  # noqa: E402

PKG = ROOT / "portbench"
ALLOWED = {"repro_torch", "portbench", "numpy", "torch", "pytest"}


def test_forbidden_names_compare_the_whole_top_level_name():
    assert modcheck.forbidden_modules(["repro.core.engine"]) == ["repro"]
    assert modcheck.forbidden_modules(["jax", "jaxlib.xla_client",
                                       "flax.linen"]) == ["flax", "jax",
                                                          "jaxlib"]
    assert modcheck.forbidden_modules(["repro_torch", "repro_torch.core",
                                       "reprox", "jaxtyping",
                                       "portbench.run"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_only_the_port_and_the_standard_library():
    stdlib = set(sys.stdlib_module_names)
    for path in PKG.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top in stdlib | ALLOWED, (path, name)
            assert top not in modcheck.FORBIDDEN | {"benchmarks", "chip_smoke"}


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "prosite17-shards",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_loads_neither_jax_nor_the_jax_package():
    """The CLI up to its card check, in a fresh process: the port and the
    harness load no forbidden module."""
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            "'prosite17-shards', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']\n"
            "try:\n    runpy.run_path('portbench/run.py', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "from portbench import modcheck, harness\n"
            "import repro_torch.core.engine\n"
            "print(modcheck.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr
