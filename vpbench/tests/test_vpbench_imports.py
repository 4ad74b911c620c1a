"""Nothing under vpbench/ imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "vanishing_points_2017_tpu"}
PORT = "vanishing_points_2017_tpu_torch"


def _imports(path: str) -> list:
    """(top-level name, level) of every import statement in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def _sources(sub: str = "") -> list:
    base = os.path.join(HERE, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs
            if f.endswith(".py")]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for name, level in _imports(path):
            assert level > 0 or name not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for name, level in _imports(path):
            assert name != PORT, path
            # relative imports stay inside the reference package
            assert level <= 1, (path, name, level)


def test_reference_loads_no_port_module():
    code = ("import sys, vpbench.reference.pipeline, vpbench.judge;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {PORT}), tops & (FORBIDDEN | {PORT})


def test_harness_loads_no_jax():
    code = ("import sys, vpbench.run, vpbench.calibrate, vpbench.stages,"
            " vanishing_points_2017_tpu_torch.pipeline;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & FORBIDDEN
