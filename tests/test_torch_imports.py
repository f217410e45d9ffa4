"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no module of it (nor chip_smoke.py, nor kernel_ab.py) imports
them."""
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
    return files + [osp.join(REPO, "kernel_ab.py"), osp.join(REPO, "chip_smoke.py")]


def _port_modules():
    """Every module of the port, as a dotted name under the package."""
    pkg = osp.join(REPO, "exavatar_release_tpu_torch")
    mods = []
    for p in _port_files()[:-2]:
        rel = osp.relpath(p, pkg)[:-3].replace(osp.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return [m for m in mods if m != "__init__"]


# the differentiable frame's modules: each must be among the files the checks walk
FRAME_MODULES = (
    "core.sh", "avatar.scene", "avatar.losses", "avatar.model", "avatar.param_dict",
    "avatar.gaussians", "avatar.convert", "ops.mesh_raster", "ops.image_metrics", "ops.lpips",
    "ops.knn", "ops.rasterizer.binning", "ops.rasterizer.kernels", "ops.rasterizer.api",
    "train.loop",
)


def test_module_list_covers_the_frame_modules():
    mods = _port_modules()
    missing = [m for m in FRAME_MODULES if m not in mods]
    assert not missing, missing


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
    assert len(files) > 30
    bad = [(osp.relpath(p, REPO), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, exavatar_release_tpu_torch\n"
        "import importlib\n"
        "for m in %r:\n"
        "    importlib.import_module('exavatar_release_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n" % (_port_modules(), FORBIDDEN)
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
