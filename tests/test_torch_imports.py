"""The port stands alone: importing it loads neither JAX nor the JAX
package (nor cv2, which the avatar path does without), and no module of
it (nor chip_smoke.py, nor kernel_ab.py) imports them or the JAX
repository's tools/.

The import checks run in one fresh interpreter (``imports``): it loads
numpy and torch, the port's own dependencies, then forks a child per check,
all at once, each of which imports its module (or modules) before any other
module of the port and reports what it loaded."""
import ast
import glob
import json
import os.path as osp
import subprocess
import sys

import pytest

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


# the probe tools, the apps slice and the preprocessing apps (whose
# detectors and file plumbing import cv2 only when they run)
APPS_MODULES = ("tools.kvariants", "tools.win_probe", "data.colmap", "data.subject",
                "native.loader", "utils.logging", "utils.png", "utils.vis", "apps.common",
                "apps.train", "apps.test", "apps.evaluate", "apps.animate",
                "core.geometry", "data.fitting_init", "data.depth_cloud", "apps.extract_frames",
                "apps.prepare_fit_pose_to_test", "apps.run_mmpose", "apps.run_sam",
                "apps.run_depth_anything", "apps.preprocess")
TRAIN_ALONE = ("train.optim", "train.checkpoint", "apps.train", "avatar.convert")
# the last functions of the JAX package to be ported, by module
# (tests/test_torch_last_functions.py holds each against JAX)
LAST_FUNCTIONS = {
    "core.camera": ("world_to_cam", "cam_to_world", "cam_to_pixel", "pixel_to_cam",
                    "get_view_matrix", "get_proj_matrix", "full_projection"),
    "core.sh": ("eval_sh",),
    "core.rotations": ("quaternion_multiply",),
    "fitting.keypoints": ("flame_full_keypoints", "FLAME_KPT_NUM"),
    "ops.rasterizer.binning": ("bin_gaussians_scan",),
    "models.smplx.structs": ("np_faces",),
}

_FORK_CHECKS = """
import importlib, json, os, sys
import numpy, torch  # the port's own dependencies, loaded once
checks = json.loads(sys.argv[1])
kids = {}
for name, mods in checks.items():  # all children at once
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # the child: the modules first, then what got loaded
        os.close(r)
        try:
            for m in mods:
                importlib.import_module("exavatar_release_tpu_torch" + ("." + m if m else ""))
            msg = sorted({k.split(".")[0] for k in sys.modules})
        except BaseException as e:
            msg = "error: " + repr(e)
        os.write(w, json.dumps(msg).encode())
        os._exit(0)
    os.close(w)
    kids[name] = (pid, r)
out = {}
for name, (pid, r) in kids.items():
    data = b""
    while True:
        chunk = os.read(r, 1 << 16)
        if not chunk:
            break
        data += chunk
    os.close(r)
    os.waitpid(pid, 0)
    out[name] = json.loads(data)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imports():
    """{check: the top-level modules loaded, or "error: ..."}: each module of
    APPS_MODULES, TRAIN_ALONE and LAST_FUNCTIONS alone, and "all": the
    package and every module of it."""
    checks = {m: [m] for m in APPS_MODULES + TRAIN_ALONE + tuple(LAST_FUNCTIONS)}
    checks["all"] = [""] + _port_modules()
    r = subprocess.run([sys.executable, "-c", _FORK_CHECKS, json.dumps(checks)], cwd=REPO,
                       check=True, timeout=300, capture_output=True, text=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def _loaded(imports, check, forbidden):
    got = imports[check]
    assert not isinstance(got, str), (check, got)
    return [m for m in got if m in forbidden]


def test_module_list_covers_the_apps_modules():
    mods = _port_modules()
    missing = [m for m in APPS_MODULES if m not in mods]
    assert not missing, missing


def test_each_apps_module_imports_alone_without_jax_or_cv2(imports):
    bad = {m: _loaded(imports, m, FORBIDDEN + ("cv2",)) for m in APPS_MODULES}
    assert not any(bad.values()), bad


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


def test_last_functions_import_alone_without_jax(imports):
    """Each module of the last functions ported imports first in a process
    of its own, loads no JAX, and holds its new names."""
    import importlib

    bad = {m: _loaded(imports, m, FORBIDDEN) for m in LAST_FUNCTIONS}
    assert not any(bad.values()), bad
    missing = [(m, n) for m, names in LAST_FUNCTIONS.items() for n in names
               if not hasattr(importlib.import_module("exavatar_release_tpu_torch." + m), n)]
    assert not missing, missing
    assert sum(len(v) for v in LAST_FUNCTIONS.values()) == 13  # 12 functions, 1 constant


def test_each_train_module_imports_alone_without_jax(imports):
    """Every new module in a clean process of its own: importing it first
    (before any other module of the port) must work and load no JAX."""
    bad = {m: _loaded(imports, m, FORBIDDEN) for m in TRAIN_ALONE}
    assert not any(bad.values()), bad


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


def test_import_leaves_jax_unloaded(imports):
    assert not _loaded(imports, "all", FORBIDDEN + ("cv2", "triton"))
