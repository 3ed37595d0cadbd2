"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the program."""
import ast
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _files(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _files(BENCH):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in _files(os.path.join(BENCH, "reference")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "numpy", "torch", "bench"}, (path, tops)
