"""The port stands alone: importing it loads neither JAX nor the JAX
package (nor cv2, which the machine with the card lacks), and no module of
it (nor chip_smoke.py, nor kernel_ab.py) imports them or the JAX
repository's tools/."""
import ast
import glob
import os.path as osp
import subprocess
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "exavatar_release_tpu", "tools")


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


# the train step's modules, and the row-major path's
TRAIN_MODULES = ("train.optim", "train.checkpoint", "train.loop", "apps.train", "avatar.scene",
                 "avatar.convert", "ops.rasterizer.preprocess", "ops.rasterizer.kernels")


def test_module_list_covers_the_train_modules():
    mods = _port_modules()
    missing = [m for m in TRAIN_MODULES if m not in mods]
    assert not missing, missing


# the probe tools and the apps slice
APPS_MODULES = ("tools.kvariants", "tools.win_probe", "data.colmap", "data.subject",
                "native.loader", "utils.logging", "utils.png", "utils.vis", "apps.common",
                "apps.train", "apps.test", "apps.evaluate", "apps.animate")


def test_module_list_covers_the_apps_modules():
    mods = _port_modules()
    missing = [m for m in APPS_MODULES if m not in mods]
    assert not missing, missing


def test_each_apps_module_imports_alone_without_jax_or_cv2():
    code = (
        "import sys, importlib\n"
        "importlib.import_module('exavatar_release_tpu_torch.' + sys.argv[1])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r + ('cv2',)]\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    for m in APPS_MODULES:
        subprocess.run([sys.executable, "-c", code, m], cwd=REPO, check=True, timeout=120)


# the fitting half and its two CLIs, which import cv2 only for the check renders
FIT_MODULES = ("utils.mesh_io", "utils.vis", "fitting", "fitting.config", "fitting.kpt_convert",
               "fitting.keypoints", "fitting.smooth", "fitting.params", "fitting.losses",
               "fitting.model", "fitting.fit", "fitting.unwrap", "fitting.convert", "apps.fit",
               "apps.unwrap")


def test_module_list_covers_the_fitting_modules():
    """The fitting half and its CLIs are among the modules that
    test_import_leaves_jax_unloaded imports (no JAX, cv2 or triton loaded)."""
    mods = _port_modules()
    missing = [m for m in FIT_MODULES if m not in mods]
    assert not missing, missing


def test_each_train_module_imports_alone_without_jax():
    """Every new module in a clean process of its own: importing it first
    (before any other module of the port) must work and load no JAX."""
    code = (
        "import sys, importlib\n"
        "importlib.import_module('exavatar_release_tpu_torch.' + sys.argv[1])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    for m in ("train.optim", "train.checkpoint", "apps.train", "avatar.convert"):
        subprocess.run([sys.executable, "-c", code, m], cwd=REPO, check=True, timeout=120)


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
        "bad = [m for m in sys.modules if m.split('.')[0] in %r + ('cv2', 'triton')]\n"
        "assert not bad, bad\n" % (_port_modules(), FORBIDDEN)
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
