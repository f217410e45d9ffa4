"""The port's real-asset loaders against the JAX package's on hand-built
files in the released layout (no licensed file is needed): the FLAME-2019
expression-vertex derivation on tests/test_real_assets.py's pickles, the
SMPL-X / FLAME / correspondence loaders and the prior built from their
tables on a directory that chip_smoke.py writes from the synthetic arrays,
the apps' ``build_prior_for`` / ``face_mesh_for`` on it at the real vertex
count, and the LPIPS state-dict converter on tests/test_image_metrics.py's
synthetic checkpoints. Everything here is numpy and pickle on both sides,
so every comparison is exact."""
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch

import test_image_metrics as tim
from exavatar_release_tpu.apps import common as jc
from exavatar_release_tpu.models.smplx import assets_io as ja
from exavatar_release_tpu.models.smplx import flame as jf
from exavatar_release_tpu.models.smplx import prior as jpr
from exavatar_release_tpu.ops import lpips as jl
from exavatar_release_tpu_torch.apps import common as tc
from exavatar_release_tpu_torch.models.smplx import assets_io as ta
from exavatar_release_tpu_torch.models.smplx import flame as tf
from exavatar_release_tpu_torch.models.smplx import prior as tpr
from exavatar_release_tpu_torch.ops import lpips as tl

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
import chip_smoke  # noqa: E402  (write_human_model_dir)

torch.set_num_threads(2)

ASSET_FIELDS = ("v_template", "shapedirs", "expr_dirs", "posedirs", "joint_regressor",
                "lbs_weights", "pose_mean", "faces", "lmk_faces_idx", "lmk_bary_coords",
                "dyn_lmk_faces_idx", "dyn_lmk_bary_coords")
PRIOR_FIELDS = ("faces_with_cavity", "is_cavity", "face_vertex_idx", "lhand_vertex_idx",
                "rhand_vertex_idx", "expr_vertex_idx", "neutral_body_pose", "neutral_jaw_pose",
                "faces_upsampled", "is_rhand_hr", "is_lhand_hr", "is_face_hr",
                "is_face_expr_hr", "is_cavity_hr")


def same_assets(got, want):
    for k in ASSET_FIELDS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert got.parents == want.parents and got.neck_kin_chain == want.neck_kin_chain


def same_prior(got, want):
    same_assets(got.assets, want.assets)
    for k in PRIOR_FIELDS:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    assert got.vertex_num_upsampled == want.vertex_num_upsampled


def _pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_derive_expr_vertex_idx_flame2019(tmp_path):
    """tests/test_real_assets.py's two pickles: expression support minus
    neck- and eye-dominated vertices, and the 300:300+dim window."""
    Vf = 20
    shapedirs = np.zeros((Vf, 3, 360), np.float64)
    shapedirs[3:13, 1, 310] = 1e-3
    shapedirs[15, 0, 349] = 2.0
    shapedirs[0, 0, 5] = 1.0
    weights = np.zeros((Vf, 5), np.float64)
    weights[:, 1] = 1.0
    weights[4], weights[5], weights[15], weights[6] = ([1, 0, 0, 0, 0], [0, 0, 0, 1, 0],
                                                       [0, 0, 0, 0, 1], [0, 0, 1, 0, 0])
    pkl = _pickle(tmp_path / "a.pkl", {"shapedirs": shapedirs, "weights": weights,
                                       "v_template": np.zeros((Vf, 3))})
    fvi = (np.arange(Vf) * 7 + 100).astype(np.int32)
    got = tpr.derive_expr_vertex_idx_flame2019(pkl, fvi)
    np.testing.assert_array_equal(got, jpr.derive_expr_vertex_idx_flame2019(pkl, fvi))
    np.testing.assert_array_equal(got, fvi[[3, 6, 7, 8, 9, 10, 11, 12]])
    assert got.dtype == np.int32

    shapedirs = np.zeros((8, 3, 400), np.float64)
    shapedirs[2, 0, 310] = shapedirs[3, 0, 370] = 1.0
    weights = np.zeros((8, 5), np.float64)
    weights[:, 1] = 1.0
    pkl = _pickle(tmp_path / "b.pkl", {"shapedirs": shapedirs, "weights": weights,
                                       "v_template": np.zeros((8, 3))})
    fvi = np.arange(8, dtype=np.int32)
    for dim in (50, 71):
        got = tpr.derive_expr_vertex_idx_flame2019(pkl, fvi, expr_param_dim=dim)
        np.testing.assert_array_equal(
            got, jpr.derive_expr_vertex_idx_flame2019(pkl, fvi, expr_param_dim=dim))
    np.testing.assert_array_equal(tpr.derive_expr_vertex_idx_flame2019(pkl, fvi), [2])


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("human_model_small"))
    chip_smoke.write_human_model_dir(root, rings=8, segs=12, num_shape=6, num_expr=4)
    return root


def test_loaders_on_the_released_layout(small_dir, tmp_path):
    for graft in (True, False):
        got = ta.load_smplx_assets(small_dir, "male", 6, 4, graft_flame_expr=graft, device="cpu")
        same_assets(got, ja.load_smplx_assets(small_dir, "male", 6, 4, graft_flame_expr=graft))
    np.testing.assert_array_equal(ta._load_flame_expr_dirs(small_dir, 4),
                                  ja._load_flame_expr_dirs(small_dir, 4))
    assert ta._load_flame_expr_dirs(str(tmp_path), 4) is None
    same_assets(tf.load_flame_assets(small_dir, 6, 4, device="cpu"),
                jf.load_flame_assets(small_dir, 6, 4))
    for g, w in zip(tf.load_flame_uv(small_dir), jf.load_flame_uv(small_dir)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the npz form of the FLAME model, without the landmark embeddings
    npz_dir = tmp_path / "npz"
    (npz_dir / "flame").mkdir(parents=True)
    with open(osp.join(small_dir, "flame", "generic_model.pkl"), "rb") as f:
        np.savez(npz_dir / "flame" / "FLAME_NEUTRAL.npz", **pickle.load(f))
    same_assets(tf.load_flame_assets(str(npz_dir), 6, 4, device="cpu"),
                jf.load_flame_assets(str(npz_dir), 6, 4))
    np.testing.assert_array_equal(ta._load_flame_expr_dirs(str(npz_dir), 4),
                                  ja._load_flame_expr_dirs(str(npz_dir), 4))


def test_prior_from_the_tables(small_dir):
    got, want = tpr.load_prior_tables(small_dir), jpr.load_prior_tables(small_dir)
    assert set(got) == set(want) == {"face_vertex_idx", "lhand_vertex_idx", "rhand_vertex_idx",
                                     "expr_vertex_idx"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32 and np.array_equal(got[k], want[k]), k
    lips = tuple(int(i) for i in got["face_vertex_idx"][:8])
    tables = {k: got[k] for k in ("face_vertex_idx", "lhand_vertex_idx", "rhand_vertex_idx",
                                  "expr_vertex_idx")}
    same_prior(tpr.build_prior(ta.load_smplx_assets(small_dir, "male", 6, 4, device="cpu"),
                               lip_vertex_idx=lips, **tables),
               jpr.build_prior(ja.load_smplx_assets(small_dir, "male", 6, 4),
                               lip_vertex_idx=lips, **tables))


def test_apps_build_prior_and_face_mesh_at_the_real_vertex_count(tmp_path):
    """The apps' path with ``--human_model_path``: the real lip vertices
    (up to 8977) need the real vertex count (10,272 here)."""
    root = str(tmp_path / "human_model")
    written = chip_smoke.write_human_model_dir(root)
    got = tc.build_prior_for(root, "male", "cpu")
    same_prior(got, jc.build_prior_for(root, "male"))
    assert got.assets.num_vertices > max(tpr.REAL_LIP_VERTEX_IDX)
    np.testing.assert_array_equal(got.face_vertex_idx.numpy(), written["face_ids"])
    for g, w in zip(tc.face_mesh_for(root, got), jc.face_mesh_for(root, None)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # no path: the synthetic body and its placeholder face mesh, as before
    syn = tc.build_prior_for(None, "male", "cpu")
    rings, segs = tc.SYNTHETIC_BODY["rings"], tc.SYNTHETIC_BODY["segs"]
    assert syn.assets.num_vertices == (rings - 1) * segs + 2
    assert np.array_equal(tc.face_mesh_for(None, syn)[0], tc.synthetic_face_mesh(syn)[0])


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_convert_torch_state_dicts_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    sd, lins = tim.TestLPIPSConverter()._vgg_sd(rng)
    prefixed = {f"features.{k}": v for k, v in sd.items()}
    alex_shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
                   (256, 256, 3, 3)]
    alex = {}
    for i, s in zip((0, 3, 6, 8, 10), alex_shapes):
        alex[f"{i}.weight"] = torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32))
        alex[f"{i}.bias"] = rng.normal(0, 0.01, (s[0],)).astype(np.float32)  # numpy leaves too
    alex_lins = {f"lin{i}.weight": torch.from_numpy(
        np.abs(rng.normal(0, 0.1, (1, d, 1, 1))).astype(np.float32))
        for i, d in enumerate([64, 192, 384, 256, 256])}
    for name, (f, l, net) in {"vgg": (sd, lins, "vgg"), "prefixed": (prefixed, lins, "vgg"),
                              "alex": (alex, alex_lins, "alex")}.items():
        got, want = str(tmp_path / f"t_{name}.npz"), str(tmp_path / f"j_{name}.npz")
        tl.convert_torch_state_dicts(got, f, l, net)
        jl.convert_torch_state_dicts(want, f, l, net)
        g, w = _npz(got), _npz(want)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (name, k)
        params = tl.load_lpips(got, device="cpu")
        assert params.net == net and len(params.conv_weights) == int(w["n_conv"])
    np.testing.assert_array_equal(params.conv_weights[0].numpy(), alex["0.weight"].numpy())
    bad = dict(sd)
    del bad["28.weight"]
    with pytest.raises(KeyError):
        tl.convert_torch_state_dicts(str(tmp_path / "x.npz"), bad, lins, "vgg")
    with pytest.raises(KeyError):
        tl.convert_torch_state_dicts(str(tmp_path / "y.npz"), sd, {"lin0.weight": 0}, "vgg")
