"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no module of it (nor chip_smoke.py) imports them."""
import ast
import glob
import os.path as osp
import subprocess
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "exavatar_release_tpu")


def _port_files():
    files = sorted(glob.glob(osp.join(REPO, "exavatar_release_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [osp.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_import_in_source():
    files = _port_files()
    assert len(files) > 20
    bad = [(osp.relpath(p, REPO), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, exavatar_release_tpu_torch\n"
        "import exavatar_release_tpu_torch.apps.animate\n"
        "import exavatar_release_tpu_torch.avatar.convert\n"
        "import exavatar_release_tpu_torch.cuda_build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n" % (FORBIDDEN,)
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
