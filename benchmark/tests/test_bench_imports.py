"""What the benchmark runs loads no JAX and no JAX package, and the plain
reference and the yardsticks import nothing of the system under test."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


@pytest.mark.parametrize("mods,want", [
    ({"hefl_tpu_torch", "hefl_tpu_torch.fl.secure", "torch"}, []),
    ({"hefl_tpu.ckks.ops"}, ["hefl_tpu"]),
    ({"jax._src.core", "jaxlib"}, ["jax", "jaxlib"]),
    ({"jaxtyping", "flaxen", "optax_like"}, []),
    ({"flax.linen", "optax"}, ["flax", "optax"]),
])
def test_forbidden_modules_compare_whole_names(mods, want):
    assert forbidden_modules(mods) == want


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _files(*parts):
    top = os.path.join(BENCH, *parts)
    if os.path.isfile(top):
        return [top]
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


@pytest.mark.parametrize("part", ["reference", "inputs.py", "yardsticks.py", "tracing.py",
                                  "compare.py", "manifest.py", "metrics"])
def test_yardsticks_import_nothing_of_the_system(part):
    for path in _files(part):
        bad = set(_imported(path)) & {"hefl_tpu_torch", "hefl_tpu", "jax", "jaxlib", "flax",
                                      "optax"}
        assert not bad, f"{path} imports {bad}"


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, calibrate, rehearse\n"
            "import hefl_tpu_torch.fl.secure, hefl_tpu_torch.fl.fedavg, "
            "hefl_tpu_torch.ckks.keys, hefl_tpu_torch.models\n"
            "print(harness.forbidden_modules())" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
