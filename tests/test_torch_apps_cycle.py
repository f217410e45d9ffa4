"""The PyTorch port's avatar CLIs against the JAX package on the CPU, at a tiny
size (synthetic body of 8 rings x 12 segments, triplane 8 x 16, scene
capacity 512, frames of 40 x 32), on a synthetic subject directory:

* a JAX init state (heads brought into a trained avatar's range, as in
  tests/torch_frame_fixture.py) saved with JAX's ``save_checkpoint``: the
  port's ``apps.test.main`` renders every test frame within 1e-4 of JAX's
  ``forward_frame`` in test mode (backend "ref" there, the kernels' plain
  versions here), and writes the nine PNGs per frame;
* the port's ``apps.evaluate.main`` on the same snapshot gives the metrics
  JAX's functions give on JAX's renders within 1e-4, with one LPIPS-alex
  ``.npz`` that both packages load;
* the port's ``apps.train.main`` takes 2 steps with ``--device cpu`` and the
  snapshot it writes loads in JAX's ``load_checkpoint``, leaf for leaf;
* ``--mesh`` outside a torch.distributed world of its size, and
  ``--gaussian_shard`` without ``--mesh``, are refused; ``--profile_dir``
  and ``--human_model_path`` are taken.
"""
import os
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.apps import common as j_common
from exavatar_release_tpu.avatar.config import AvatarConfig as JCfg
from exavatar_release_tpu.avatar.model import forward_frame as j_forward_frame
from exavatar_release_tpu.data.subject import load_frame_arrays as j_frame_arrays
from exavatar_release_tpu.data.subject import load_subject as j_load_subject
from exavatar_release_tpu.models.smplx import build_prior as j_build_prior
from exavatar_release_tpu.models.smplx import synthetic_smplx_assets as j_assets
from exavatar_release_tpu.ops.image_metrics import psnr as j_psnr
from exavatar_release_tpu.ops.image_metrics import ssim_map as j_ssim_map
from exavatar_release_tpu.ops.lpips import init_lpips_random as j_lpips_random
from exavatar_release_tpu.ops.lpips import lpips_distance as j_lpips_distance
from exavatar_release_tpu.ops.lpips import save_lpips as j_save_lpips
from exavatar_release_tpu.ops.rasterizer import RasterizeSettings as JSettings
from exavatar_release_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from exavatar_release_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from exavatar_release_tpu.train.loop import init_train_state as j_init_state
from exavatar_release_tpu.train.optim import make_optimizer as j_make_optimizer
from exavatar_release_tpu_torch.apps import common as t_common
from exavatar_release_tpu_torch.apps import evaluate, test, train
from exavatar_release_tpu_torch.apps.test import RENDER_KEYS
from exavatar_release_tpu_torch.avatar.convert import TRAIN_STATE_LEAVES, train_state_to_numpy
from test_data import make_synthetic_subject
from torch_frame_fixture import compile_once, fast_jit
from torch_port_fixture import _j_init_human, _last_layer

torch.set_num_threads(2)

CAPACITY, CH, RES, RINGS, SEGS = 512, 8, 16, 8, 12
ARGS = ["--device", "cpu", "--scene_capacity", str(CAPACITY), "--triplane_ch", str(CH),
        "--triplane_res", str(RES)]


@fast_jit
def j_metrics(lp, render, img, mask):
    """JAX's evaluation metrics of one test frame (apps/evaluate.py's), as one
    program."""
    pred = render.transpose(2, 0, 1) * mask
    gt = img * mask
    return {"psnr": j_psnr(pred, gt, mask=mask[0]), "ssim": jnp.mean(j_ssim_map(pred, gt)),
            "lpips": j_lpips_distance(lp, pred * 2 - 1, gt * 2 - 1)}


@pytest.fixture(scope="module")
def cycle(tmp_path_factory, monkeypatch_module):
    """The subject, a JAX init state saved as snapshot_0, JAX's test-mode
    renders of every test frame and JAX's metrics on them."""
    root = str(tmp_path_factory.mktemp("subject"))
    out = str(tmp_path_factory.mktemp("out"))
    make_synthetic_subject(root, n_frames=2, H=32, W=40, seed=5)
    cfg = JCfg(scene_capacity=CAPACITY, triplane_ch=CH, triplane_res=RES)
    prior = j_build_prior(j_assets(rings=RINGS, segs=SEGS))
    subject = j_load_subject(root, split="test", repeat=1)
    faces, uv, fuv = j_common.face_mesh_for(None, prior)
    # the port's CLIs build the same tiny synthetic body
    monkeypatch_module.setitem(t_common.SYNTHETIC_BODY, "rings", RINGS)
    monkeypatch_module.setitem(t_common.SYNTHETIC_BODY, "segs", SEGS)
    # the eager initialisers cost hundreds of small compiles: the same values jitted
    monkeypatch_module.setattr(j_common, "init_human", _j_init_human)
    monkeypatch_module.setattr(j_common, "init_lpips_random",
                               fast_jit(j_common.init_lpips_random, static_argnums=(1,)))
    eager_frames = j_common.init_param_frames
    monkeypatch_module.setattr(j_common, "init_param_frames",
                               lambda frames: fast_jit(lambda: eager_frames(frames))())
    monkeypatch_module.setattr(j_common, "sc", types.SimpleNamespace(
        init_from_point_cloud=fast_jit(j_common.sc.init_from_point_cloud, static_argnums=(4,))))
    trainables, scene_state, bundle, frame_row_of = j_common.subject_bundle(
        subject, prior, cfg, faces, uv, fuv, lpips_quiet=True)
    rng = np.random.default_rng(0)
    hp = trainables.human
    hp = hp.replace(
        triplane=jnp.asarray(rng.normal(0, 1, hp.triplane.shape).astype(np.float32)),
        triplane_face=jnp.asarray(rng.normal(0, 1, hp.triplane.shape).astype(np.float32)),
        mean_offset_net=_last_layer(hp.mean_offset_net, 0.01, None),
        mean_offset_offset_net=_last_layer(hp.mean_offset_offset_net, 0.01, None),
        scale_net=_last_layer(hp.scale_net, 0.05, np.log(0.03)),
        scale_offset_net=_last_layer(hp.scale_offset_net, 0.05, 0.0))
    trainables = trainables.replace(human=hp)
    opt = j_make_optimizer(trainables, cfg, 1.0, 1)
    state = j_init_state(trainables, scene_state.aux, opt)
    model_dir = osp.join(out, "jax_dump")
    j_save_checkpoint(model_dir, state, 0)

    settings = JSettings(backend="ref")
    b = bundle
    lp = fast_jit(j_lpips_random, static_argnums=(1,))(jax.random.PRNGKey(3), "alex")
    lpips_npz = osp.join(out, "lpips_alex.npz")
    j_save_lpips(lpips_npz, lp)
    renders, metrics = {}, {"psnr": [], "ssim": [], "lpips": []}
    fwd = None
    for f in sorted(set(subject.frame_ids)):
        arrs = j_frame_arrays(subject, f)
        arrs["frame_row"] = frame_row_of[f]
        frame = j_common.frame_to_device(arrs)

        def run(tr, frame):
            return j_forward_frame(tr, state.scene_aux, b.buffers, b.prior, b.statics, b.id_info,
                                   b.lpips, b.face_texture, b.face_texture_mask,
                                   b.init_joint_offset, frame, jnp.ones(3), cfg,
                                   is_warmup=False, mode="test", settings=settings).renders

        fwd = fwd or compile_once(run, state.trainables, frame)
        r = fwd(state.trainables, frame)
        renders[f] = {k: np.asarray(r[k]) for k in RENDER_KEYS}
        for k, v in j_metrics(lp, r["scene_human_img_refined_composed"], frame.img,
                              frame.mask).items():
            metrics[k].append(float(v))
    return dict(root=root, out=out, ckpt=osp.join(model_dir, "snapshot_0.npz"),
                renders=renders, metrics={k: float(np.mean(v)) for k, v in metrics.items()},
                lpips_npz=lpips_npz, state=state)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_test_renders_match_jax(cycle):
    out_dir = osp.join(cycle["out"], "result")
    got = test.main(["--subject_root", cycle["root"], "--ckpt", cycle["ckpt"], "--out_dir",
                     out_dir] + ARGS, keep_renders=True)
    assert set(got) == set(cycle["renders"])
    for f, want in cycle["renders"].items():
        # the human is on screen: its render is not the white background alone
        assert (want["human_img"] < 0.95).mean() > 0.05
        for k in RENDER_KEYS:
            assert got[f][k].shape == want[k].shape, k
            assert float(np.abs(got[f][k] - want[k]).max()) <= 1e-4, (f, k)
    pngs = sorted(p for p in os.listdir(out_dir) if p.endswith(".png"))
    assert len(pngs) == len(cycle["renders"]) * len(RENDER_KEYS)


def test_evaluate_matches_jax(cycle):
    out_json = osp.join(cycle["out"], "metrics.json")
    got = evaluate.main(["--subject_root", cycle["root"], "--ckpt", cycle["ckpt"],
                         "--lpips_weights", cycle["lpips_npz"], "--out_json", out_json] + ARGS)
    assert osp.exists(out_json)
    for k, w in cycle["metrics"].items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)


def test_train_snapshot_loads_in_jax(cycle):
    out = osp.join(cycle["out"], "train")
    res = train.main(["--subject_root", cycle["root"], "--out_dir", out, "--repeat", "1",
                      "--epochs", "1", "--max_itrs", "2", "--allow_random_lpips",
                      "--loader", "native"] + ARGS)
    assert len(res.history) == 2 and res.state.itr == 2
    assert all(np.isfinite(h["total"]) and h["read_s"] >= 0 and h["step_s"] > 0
               for h in res.history)
    snap = osp.join(out, "model_dump", "snapshot_0.npz")
    loaded, epoch = j_load_checkpoint(snap, cycle["state"])
    assert epoch == 0
    leaves = jax.tree_util.tree_leaves(loaded)
    mine = train_state_to_numpy(res.state)
    assert len(leaves) == len(TRAIN_STATE_LEAVES)
    for name, leaf in zip(TRAIN_STATE_LEAVES, leaves):
        assert np.array_equal(np.asarray(leaf), mine[name]), name
    with open(osp.join(out, "log", "train_logs.txt")) as f:
        log = f.read()
    assert "speed:" in log and "native C++ prefetcher" in log and "saved snapshot_0" in log


@pytest.mark.parametrize("flag", [["--mesh", "data=2"], ["--gaussian_shard"],
                                  ["--profile_dir", "p"], ["--human_model_path", "assets"]])
def test_unported_flags_are_refused(cycle, flag, tmp_path):
    """``--mesh`` needs a torch.distributed world of its size (torchrun),
    which this process is not in, and ``--gaussian_shard`` needs ``--mesh``:
    both are refused with a message that says so. ``--profile_dir`` and
    ``--human_model_path`` are ported: the
    first is taken (a one-step run, which ends before the traced
    iterations), and the second reads the released files from its directory,
    so a directory without them fails in the FLAME loader, as the JAX CLI's
    ``face_mesh_for`` does."""
    args = ["--subject_root", cycle["root"], "--out_dir", str(tmp_path),
            "--allow_random_lpips"] + ARGS
    if flag[0] == "--profile_dir":
        res = train.main(args + ["--epochs", "1", "--repeat", "1", "--max_itrs", "1",
                                 "--profile_dir", str(tmp_path / flag[1])])
        assert len(res.history) == 1
    elif flag[0] == "--human_model_path":
        missing = str(tmp_path / flag[1])
        with pytest.raises(FileNotFoundError):
            j_common.face_mesh_for(missing, None)
        with pytest.raises(FileNotFoundError):
            train.main(args + [flag[0], missing])
    else:
        match = "torchrun --nproc_per_node=2" if flag[0] == "--mesh" else "give --mesh"
        with pytest.raises(SystemExit, match=match):
            train.main(args + flag)
