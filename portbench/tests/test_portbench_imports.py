"""Nothing under portbench/ imports JAX or the JAX package, and the
reference and the counts import nothing of the program. Top-level module
names are compared whole: the program's name begins with the JAX package's."""
import ast
import os

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "exavatar_release_tpu"}
PROGRAM = "exavatar_release_tpu_torch"


def sources():
    for base, _, files in os.walk(BENCH_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(base, f), BENCH_DIR)


def _literal_head(node):
    """The leading text of a string literal or f-string, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant):
            return first.value
    return None


def top_names(path: str):
    """Top-level names of every absolute import, and of every module name
    handed to ``__import__`` or ``import_module`` as a literal."""
    with open(os.path.join(BENCH_DIR, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            head = _literal_head(node.args[0])
            if name in ("__import__", "import_module") and head:
                yield head.split(".")[0]


@pytest.mark.parametrize("path", list(sources()))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in sources()
                                  if p.startswith(("reference", "counts"))])
def test_reference_and_counts_stand_alone(path):
    assert PROGRAM not in set(top_names(path))
    with open(os.path.join(BENCH_DIR, path)) as f:
        assert PROGRAM not in f.read().replace(PROGRAM + "'s", "")
