"""The PyTorch port's fitting half against the JAX package on the CPU, at the
statics of tests/test_fitting.py (synthetic SMPL-X of 8 rings x 12 segments,
FLAME 8 x 10, 6 shape and 4 expression coefficients; the SMPL-X<->FLAME
correspondence padded with its last index repeated) and 2 frames, every input
made with numpy from a seed.

The JAX side is one ``fit_step``, compiled once (``FAST_COMPILE``) and reused
for the losses, the gradients and the staged trajectory. Its gradients are
read from one step with no first moment and a second moment of 1e30: Adam's
update is then the gradient times a constant (``_jax_grads``), so no second
JAX program is built.

The comparisons at 1e-6 whose chains run through sin, cos and atan2 (the
smoothing, the initial parameters, the losses) are held under the seam of
tests/torch_xla_math.py (XLA's transcendentals for the port's) and, as the
``torch_libm`` cases, on the port's own libm, at the same bounds.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.fitting import fit as jfit
from exavatar_release_tpu.fitting import keypoints as jkp
from exavatar_release_tpu.fitting import kpt_convert as jkc
from exavatar_release_tpu.fitting.losses import synthetic_flip_correspondence as j_flip
from exavatar_release_tpu.fitting.model import FitFrameData as JFrame
from exavatar_release_tpu.fitting.model import build_fit_statics as j_build_fit_statics
from exavatar_release_tpu.fitting.params import init_fitting_params as j_init_params
from exavatar_release_tpu.fitting.params import pad_face_offset as j_pad_face_offset
from exavatar_release_tpu.fitting.params import stage_mask_tree as j_stage_mask_tree
from exavatar_release_tpu.fitting.smooth import smooth_sequence as j_smooth_sequence
from exavatar_release_tpu.fitting.unwrap import build_uv_maps as j_build_uv_maps
from exavatar_release_tpu.fitting.unwrap import unwrap_sequence as j_unwrap_sequence
from exavatar_release_tpu.models.smplx import build_prior as j_build_prior
from exavatar_release_tpu.models.smplx import synthetic_flame_assets as j_flame_assets
from exavatar_release_tpu.models.smplx import synthetic_smplx_assets as j_smplx_assets
from exavatar_release_tpu.ops.mesh_raster import rasterize_mesh as j_rasterize_mesh
from exavatar_release_tpu.utils import mesh_io as j_mesh_io
from exavatar_release_tpu.utils import vis as j_vis
from exavatar_release_tpu_torch.fitting import fit as tfit
from torch_xla_math import seam_cases, xla_transcendentals
from exavatar_release_tpu_torch.fitting import keypoints as tkp
from exavatar_release_tpu_torch.fitting import kpt_convert as tkc
from exavatar_release_tpu_torch.fitting.convert import fit_statics_from_numpy, \
    fitting_params_from_jax
from exavatar_release_tpu_torch.fitting.losses import synthetic_flip_correspondence as t_flip
from exavatar_release_tpu_torch.fitting.model import FitFrameData as TFrame
from exavatar_release_tpu_torch.fitting.model import build_fit_statics as t_build_fit_statics
from exavatar_release_tpu_torch.fitting.model import fitting_forward
from exavatar_release_tpu_torch.fitting.params import LEAVES, init_fitting_params, pad_face_offset, \
    scatter_winners
from exavatar_release_tpu_torch.fitting.params import stage_mask_tree as t_stage_mask_tree
from exavatar_release_tpu_torch.fitting.smooth import smooth_sequence as t_smooth_sequence
from exavatar_release_tpu_torch.fitting.unwrap import build_uv_maps as t_build_uv_maps
from exavatar_release_tpu_torch.fitting.unwrap import unwrap_sequence as t_unwrap_sequence
from exavatar_release_tpu_torch.models.smplx import synthetic_flame_assets as t_flame_assets
from exavatar_release_tpu_torch.models.smplx import synthetic_smplx_assets as t_smplx_assets
from exavatar_release_tpu_torch.ops.mesh_raster import rasterize_mesh as t_rasterize_mesh
from exavatar_release_tpu_torch.utils import mesh_io as t_mesh_io
from exavatar_release_tpu_torch.utils.vis import render_mesh_overlay as t_render_mesh_overlay
from torch_frame_fixture import FAST_COMPILE

torch.set_num_threads(2)

SMPLX_KW = dict(rings=8, segs=12, num_shape=6, num_expr=4, num_contour_lmk=17)
FLAME_KW = dict(rings=8, segs=10, num_shape=6, num_expr=4, num_contour_lmk=17)
N_FRAMES = 2
TABLES = ("face_vertex_idx", "extra_joint_ids", "flame_lap_idx", "flip_closest_faces",
          "right_joint_idx", "left_joint_idx", "spine_joint_idx", "hand_joint_idx",
          "flame_lap_w", "flame_is_not_neck", "flip_bc", "lear_vertex_idx", "rear_vertex_idx")
SHARED_LEAVES = ("smplx_shape", "flame_shape", "face_offset", "joint_offset", "locator_offset")
# the moments that make JAX's fit_step update = gradient x constant
NU_BIG, GRAD_SCALE = 1e30, 1e4


def _frames_numpy(E, Sf, seed=0):
    """The supervision of tests/test_fitting.py:_frames, stacked."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    per = [dict(kpt_img=f32(rng.uniform(0, 8, (135, 2))),
                kpt_valid=f32(rng.uniform(size=(135, 1)) > 0.2),
                focal_proj=f32([4.0, 4.0]), princpt_proj=f32([4.0, 4.0]),
                flame_valid=np.asarray(True),
                init_smplx_pose=f32(rng.normal(0, 0.1, (55, 3))),
                init_flame_pose=f32(rng.normal(0, 0.1, (4, 3))),
                init_flame_shape=f32(rng.normal(0, 0.5, Sf)),
                init_flame_expr=f32(rng.normal(0, 0.5, E))) for _ in range(N_FRAMES)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def _inits_numpy(E, seed=1):
    """The initial estimates of tests/test_fitting.py:_params."""
    rng = np.random.default_rng(seed)
    smplx_init = [{"root_pose": rng.normal(0, 0.1, 3), "body_pose": rng.normal(0, 0.1, (21, 3)),
                   "lhand_pose": rng.normal(0, 0.1, (15, 3)),
                   "rhand_pose": rng.normal(0, 0.1, (15, 3)),
                   "trans": np.asarray([0.0, 0.0, 3.0])} for _ in range(N_FRAMES)]
    flame_init = [{"root_pose": rng.normal(0, 0.1, 3), "neck_pose": rng.normal(0, 0.1, 3),
                   "jaw_pose": rng.normal(0, 0.1, 3), "leye_pose": np.zeros(3),
                   "reye_pose": np.zeros(3), "expr": rng.normal(0, 0.3, E),
                   "trans": np.asarray([0.0, 0.0, 3.0])} for _ in range(N_FRAMES)]
    return smplx_init, flame_init


@pytest.fixture(scope="module")
def twin():
    """JAX's statics, frames, initial parameters and compiled fit_step; the
    port's statics through ``fit_statics_from_numpy``."""
    ja = j_smplx_assets(**SMPLX_KW)
    jf, jf_prior = j_flame_assets(**FLAME_KW)
    fv = np.asarray(j_build_prior(ja).face_vertex_idx)
    Vf = jf.num_vertices
    fv = np.concatenate([fv, np.tile(fv[-1:], max(0, Vf - fv.size))])[:Vf]
    j_st = j_build_fit_statics(ja, jf, fv)
    ta = t_smplx_assets(**SMPLX_KW, device="cpu")
    tf, tf_prior = t_flame_assets(**FLAME_KW, device="cpu")
    tables = {k: np.asarray(getattr(j_st, k)) for k in TABLES}
    t_st = fit_statics_from_numpy(tables, ta, tf)
    E, Sf = jf.num_expr, jf.num_shape
    fr = _frames_numpy(E, Sf)
    smplx_init, flame_init = _inits_numpy(E)
    # jitted: the eager encoder costs many small compiles
    j_p0 = jax.jit(lambda: j_init_params(smplx_init, flame_init, np.zeros(Sf), ja.num_shape, Vf,
                                         ja.num_joints))()
    opt = jfit.make_fit_optimizer()
    j_state = jfit.init_fit_state(j_p0, opt)
    j_frames = JFrame(**{k: jnp.asarray(v) for k, v in fr.items()})
    rows = jnp.arange(N_FRAMES)
    A = jnp.asarray
    j_step = jfit.fit_step.lower(j_state, j_st, j_frames, rows, opt, A(0.01), A(True), A(True),
                                 A(True), A(False)).compile(compiler_options=FAST_COMPILE)
    step = lambda state, lr, *flags: j_step(state, j_st, j_frames, rows, A(lr),
                                            *map(A, flags))
    return dict(j_st=j_st, t_st=t_st, fv=fv, tables=tables, fr=fr, inits=(smplx_init, flame_init),
                j_p0=j_p0, opt=opt, j_step=step, ja=ja, jf=jf, jf_prior=jf_prior, ta=ta, tf=tf,
                tf_prior=tf_prior)


def _np_params(p):
    return {k: np.asarray(getattr(p, k)) for k in LEAVES}


def _t_frames(fr):
    return TFrame(**{k: torch.from_numpy(v) for k, v in fr.items()})


def _perturbed(twin, seed=2):
    """The initial parameters with every shared leaf moved off zero, the face
    offset's rows at the repeated correspondence indices all different."""
    rng = np.random.default_rng(seed)
    p = _np_params(twin["j_p0"])
    for k in SHARED_LEAVES:
        p[k] = (p[k] + rng.normal(0, 0.02, p[k].shape)).astype(np.float32)
    return p


def _jax_grads(twin, leaves, warmup, hjo):
    """(losses, {leaf: gradient}) of JAX's fitting_forward at ``leaves``, from
    one fit_step with every leaf active: with mu = 0 and nu = 1e30 the update
    is lr * (g / c1 * 0.1) / (sqrt(0.999e30 / c2) + eps), g^2 being below
    nu's rounding; lr makes it GRAD_SCALE * g."""
    j_p = twin["j_p0"].replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    st = jfit.init_fit_state(j_p, twin["opt"])
    st = st._replace(opt_state=st.opt_state._replace(
        nu=jax.tree.map(lambda x: jnp.full_like(x, NU_BIG), st.opt_state.nu)))
    f = np.float32
    c1, c2 = f(1) - f(0.9), f(1) - f(0.999)
    mu_gain = float(f(0.1) / c1)
    denom = float(np.sqrt(f(f(0.999) * f(NU_BIG)) / c2) + f(1e-8))
    new, losses = twin["j_step"](st, GRAD_SCALE * denom / mu_gain, False, True, warmup, hjo)
    grads = {k: (leaves[k].astype(np.float64) - np.asarray(getattr(new.params, k), np.float64))
             / GRAD_SCALE for k in LEAVES}
    return {k: float(v) for k, v in losses.items()}, grads


def test_mesh_io_files_read_back_by_the_other_package(tmp_path):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(10, 3)).astype(np.float32)
    f = rng.integers(0, 10, (6, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (10, 2)).astype(np.float32)
    for writer, reader in ((t_mesh_io, j_mesh_io), (j_mesh_io, t_mesh_io)):
        for colors in (c, None):
            p = str(tmp_path / "m.ply")
            writer.save_ply(p, v, f, colors)
            want, got = j_mesh_io.load_ply(p), t_mesh_io.load_ply(p)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(reader.load_ply(p)[1], f)
        p = str(tmp_path / "m.obj")
        writer.save_obj(p, v, f, uv, f)
        want, got = j_mesh_io.load_obj(p), t_mesh_io.load_obj(p)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    # the two writers write the same bytes
    t_mesh_io.save_ply(str(tmp_path / "t.ply"), v, f, c)
    j_mesh_io.save_ply(str(tmp_path / "j.ply"), v, f, c)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_keypoint_tables_and_conversion(twin):
    for name in ("SMPLX_EXTRA_JOINT_VERTEX_IDS", "SMPLX_KPT_NAMES", "SMPLX_KPT_IDX",
                 "KPT_ROOT_IDX", "KPT_PART_IDX"):
        assert getattr(tkp, name) == getattr(jkp, name), name
    assert tkc.COCO_WHOLEBODY_133_NAMES == jkc.COCO_WHOLEBODY_133_NAMES
    k133 = np.random.default_rng(4).normal(size=(133, 3)).astype(np.float32)
    np.testing.assert_array_equal(tkc.coco133_to_smplx135(k133), jkc.coco133_to_smplx135(k133))
    np.testing.assert_array_equal(tkp.extra_joint_ids_for(twin["ta"]),
                                  jkp.extra_joint_ids_for(twin["ja"]))
    # full_keypoints gathers the same rows of the same forward output
    rng = np.random.default_rng(10)
    ta = twin["ta"]
    out = {k: rng.normal(size=(n, 3)).astype(np.float32)
           for k, n in (("vertices", ta.num_vertices), ("joints", ta.num_joints),
                        ("landmarks", 68))}
    tout = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in out.items()})
    jout = SimpleNamespace(**{k: jnp.asarray(v) for k, v in out.items()})
    np.testing.assert_array_equal(tkp.full_keypoints(tout, ta).numpy(),
                                  np.asarray(jkp.full_keypoints(jout, twin["ja"])))


def test_statics_flip_correspondence_and_duplicate_winner(twin):
    # the port's own statics equal JAX's tables
    t_own = t_build_fit_statics(twin["ta"], twin["tf"], twin["fv"])
    for k in TABLES:
        got, want = getattr(t_own, k), twin["tables"][k]
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=k)
    # the chunked flip correspondence is the JAX package's, chunk edges included
    v, f = np.asarray(twin["ja"].v_template), np.asarray(twin["ja"].faces)
    for got, want in zip(t_flip(v, f, chunk=7), j_flip(v, f)):
        np.testing.assert_array_equal(got, want)
    # the scatter of the face offset keeps JAX's row where an index repeats,
    # and gives JAX's gradient to that row alone
    fv = twin["fv"]
    assert fv.size > np.unique(fv).size
    V = twin["ta"].num_vertices
    off = np.random.default_rng(5).normal(size=(fv.size, 3)).astype(np.float32)
    wts = np.random.default_rng(6).normal(size=(V, 3)).astype(np.float32)
    want = np.asarray(j_pad_face_offset(jnp.asarray(off), jnp.asarray(fv), V))
    want_g = np.asarray(jax.jit(jax.grad(lambda o: jnp.sum(
        j_pad_face_offset(o, jnp.asarray(fv), V) * wts)))(jnp.asarray(off)))
    t_off = torch.from_numpy(off).requires_grad_(True)
    winners = tuple(torch.from_numpy(w) for w in scatter_winners(fv))
    got = pad_face_offset(t_off, winners, V)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(wts)).sum(), [t_off])
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_smooth_sequence(twin, seam):
    rng = np.random.default_rng(7)
    F = 11
    seq = [{"root_pose": rng.normal(0, 0.5, 3), "trans": rng.normal(0, 1, 3),
            "expr": rng.normal(0, 1, 4),
            "betas": rng.normal(0, 1, 6)} for _ in range(F)]
    for window in (9, 5, 15):
        want = j_smooth_sequence(seq, window)
        with xla_transcendentals(seam):
            got = t_smooth_sequence(seq, window)
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("seam", [True, False], ids=["xla_libm", "torch_libm"])
def test_init_params_and_stage_masks(twin, seam):
    smplx_init, flame_init = twin["inits"]
    tf, ta = twin["tf"], twin["ta"]
    with xla_transcendentals(seam):
        t_p = init_fitting_params(smplx_init, flame_init, np.zeros(tf.num_shape), ta.num_shape,
                                  tf.num_vertices, ta.num_joints, device="cpu")
    want = _np_params(twin["j_p0"])
    for k, v in t_p.named().items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for root_only in (True, False):
        for allow_shared in (True, False):
            jm = j_stage_mask_tree(twin["j_p0"], jnp.asarray(root_only), jnp.asarray(allow_shared))
            tm = t_stage_mask_tree(root_only, allow_shared)
            for k in LEAVES:
                assert getattr(tm, k) == float(getattr(jm, k)), (k, root_only, allow_shared)


@pytest.mark.parametrize("flags, seam", seam_cases(
    {"True-False": (True, False), "True-True": (True, True), "False-True": (False, True),
     "False-False": (False, False)}))
def test_fitting_forward_losses_and_gradients(twin, flags, seam):
    """Every loss term by name (rtol 1e-5, atol 1e-6) and every leaf's
    gradient (1e-4 of the leaf's largest magnitude, plus an absolute 2^-14:
    ``smplx_to_flame_lap`` weighs the squared Laplacian of the zero-pose face
    by 1e5, and that mesh depends on the joint offsets through float32
    rounding alone, so its gradient there is rounding noise in steps of 2^-17
    in both packages; in float64 the port puts JAX's own float32 value 2
    steps from the exact one)."""
    warmup, hjo = flags
    leaves = _perturbed(twin)
    want_losses, want_grads = _jax_grads(twin, leaves, warmup, hjo)
    t_p = fitting_params_from_jax(leaves, device="cpu")
    state = tfit.init_fit_state(t_p, tfit.make_fit_optimizer())
    with xla_transcendentals(seam):
        losses = fitting_forward(state.params, twin["t_st"], _t_frames(twin["fr"]),
                                 torch.arange(N_FRAMES), warmup, hjo)
        tot = sum(losses.values())
    assert list(losses) == sorted(want_losses.keys() - {"total"})
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), want_losses[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tot), want_losses["total"], rtol=1e-5, atol=1e-6)
    assert (want_losses["flame_to_smplx_v2v"] > 0) == warmup
    assert (want_losses["smplx_pose"] > 0) != warmup
    with xla_transcendentals(seam):
        grads = torch.autograd.grad(tot, list(state.params.named().values()))
    for k, g in zip(LEAVES, grads):
        w = want_grads[k]
        scale = np.abs(w).max()
        assert scale > 0 or warmup, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale + 2.0 ** -14,
                                   err_msg=k)


def test_staged_trajectory_and_frozen_leaves(twin):
    """3 steps root_only, 6 with every leaf, 3 with the shared leaves frozen,
    through reinit_opt_on_stage_change in both packages: losses rtol 1e-4,
    leaves rtol 2e-3 / atol 2e-5 (tests/test_fitting.py:444, :459) after
    each stage, but ``joint_offset`` at rtol 5e-3 / atol 5e-5
    (tests/test_fitting.py:478, the same schedule): its Head row's gradient
    carries the float32 rounding of ``smplx_to_flame_lap`` in both packages
    (test_fitting_forward_losses_and_gradients), and Adam divides that by the
    row's own small gradient; the leaves a stage freezes move exactly 0 in
    both."""
    schedule = ((3, True, True), (6, False, True), (3, False, False))
    j_state = jfit.init_fit_state(twin["j_p0"], twin["opt"])
    t_p = fitting_params_from_jax(_np_params(twin["j_p0"]), device="cpu")
    t_opt = tfit.make_fit_optimizer()
    t_state = tfit.init_fit_state(t_p, t_opt)
    frames, rows = _t_frames(twin["fr"]), torch.arange(N_FRAMES)
    j_prev = t_prev = None
    for n, root_only, allow_shared in schedule:
        stage = (root_only, allow_shared)
        j_state, j_prev = jfit.reinit_opt_on_stage_change(j_state, twin["opt"], j_prev, stage)
        t_state, t_prev = tfit.reinit_opt_on_stage_change(t_state, t_opt, t_prev, stage)
        j_before, t_before = _np_params(j_state.params), {
            k: v.detach().clone().numpy() for k, v in t_state.params.named().items()}
        j_losses, t_losses = [], []
        for _ in range(n):
            j_state, jl = twin["j_step"](j_state, 1e-2, root_only, allow_shared, False, False)
            t_state, tl = tfit.fit_step(t_state, twin["t_st"], frames, rows, t_opt, 1e-2,
                                        root_only, allow_shared, False, False)
            j_losses.append(float(jl["total"]))
            t_losses.append(float(tl["total"]))
        np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
        j_after = _np_params(j_state.params)
        mask = t_stage_mask_tree(root_only, allow_shared)
        for k, v in t_state.params.named().items():
            tol = dict(rtol=5e-3, atol=5e-5) if k == "joint_offset" else dict(rtol=2e-3,
                                                                               atol=2e-5)
            np.testing.assert_allclose(v.detach().numpy(), j_after[k], err_msg=k, **tol)
            if getattr(mask, k) == 0.0:
                np.testing.assert_array_equal(v.detach().numpy(), t_before[k], err_msg=k)
                np.testing.assert_array_equal(j_after[k], j_before[k], err_msg=k)
            else:
                assert not np.array_equal(j_after[k], j_before[k]), k
    assert t_losses[-1] < t_losses[0] and j_losses[-1] < j_losses[0]
    assert t_state.opt_state.count == 3


def _uv_tie(j_uv, t_uv, thr=1e-4):
    """(Hu, Wu) bool: UV pixels whose winning face may flip between the
    packages: covered by a face on both sides (the atlas is drawn at one
    depth, so where faces overlap, the synthetic sphere's seam and poles,
    the z-test ties and rounding picks), or on an edge of the atlas (a
    barycentric coordinate below ``thr`` on either side)."""
    both = (np.asarray(j_uv.face_idx) >= 0) & (t_uv.face_idx.numpy() >= 0)
    return both | (np.asarray(j_uv.bary).min(-1) < thr) | (t_uv.bary.numpy().min(-1) < thr)


def _frame_margin(uv, mesh, faces, focal, princpt, H, W, z_tol=0.01):
    """(Hu, Wu): in float64, the smallest distance of a UV pixel's unwrap
    decision from its threshold in one frame: its projected point from a
    pixel edge (the z-buffer lookup) and the image border, and its depth from
    the z-buffer's plus ``z_tol`` (the visibility test), against the port's
    z-buffer."""
    sel = np.maximum(np.asarray(uv.face_idx), 0)
    tri = np.asarray(mesh, np.float64)[np.asarray(faces)[sel]]
    pts = np.einsum("hwk,hwkc->hwc", np.asarray(uv.bary, np.float64), tri)
    z = np.maximum(pts[..., 2], 1e-6)
    px = pts[..., 0] / z * focal[0] + princpt[0]
    py = pts[..., 1] / z * focal[1] + princpt[1]
    zbuf = t_rasterize_mesh(*map(torch.from_numpy, (mesh, faces, focal, princpt)),
                            (H, W)).zbuf.double().numpy()
    frac = lambda x: np.abs(x - np.round(x))
    ix = np.clip(px.astype(np.int64), 0, W - 1)
    iy = np.clip(py.astype(np.int64), 0, H - 1)
    dz = np.abs(z - (zbuf[iy, ix] + z_tol))
    return np.minimum.reduce([frac(px), frac(py), dz])


def _j_compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def test_uv_maps_and_unwrap(twin):
    """32x32 UV atlas, two 64x64 frames: face index and mask equal but on
    ties (a differing face is an edge or depth tie of the atlas, a differing
    mask pixel has a differing face or lies within 1e-4 of an unwrap
    threshold in some frame); texture within 1e-5 where both masks are set
    on the same face."""
    jf, tf = twin["jf"], twin["tf"]
    # jitted: eager, each of its many small operations compiles on its own
    vuv, fuv = twin["jf_prior"].vertex_uv, twin["jf_prior"].face_uv
    j_uv = _j_compiled(lambda v, f: j_build_uv_maps(v, f, (32, 32)), vuv, fuv)(vuv, fuv)
    t_uv = t_build_uv_maps(twin["tf_prior"].vertex_uv, twin["tf_prior"].face_uv, (32, 32))
    j_fi, t_fi = np.asarray(j_uv.face_idx), t_uv.face_idx.numpy()
    uv_tie = _uv_tie(j_uv, t_uv)
    assert ((j_fi == t_fi) | uv_tie).all() and (j_fi >= 0).mean() > 0.2
    hit = (j_fi >= 0) & (t_fi >= 0) & (j_fi == t_fi)
    np.testing.assert_allclose(t_uv.bary.numpy()[hit], np.asarray(j_uv.bary)[hit], atol=1e-5)

    rng = np.random.default_rng(8)
    base = np.asarray(jf.v_template) + np.asarray([0.0, 0.0, 0.5], np.float32)
    meshes = np.stack([base, base + rng.normal(0, 0.005, base.shape)]).astype(np.float32)
    imgs = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    focals = np.asarray([[100.0, 100.0], [110.0, 105.0]], np.float32)
    princpts = np.asarray([[32.0, 32.0], [31.0, 33.5]], np.float32)
    faces = np.asarray(jf.faces)
    j_args = (j_uv, *map(jnp.asarray, (meshes, faces, imgs, focals, princpts)))
    j_tex, j_mask = _j_compiled(j_unwrap_sequence, *j_args)(*j_args)
    t_tex, t_mask = t_unwrap_sequence(t_uv, torch.from_numpy(meshes), tf.faces,
                                      torch.from_numpy(imgs), torch.from_numpy(focals),
                                      torch.from_numpy(princpts))
    j_mask, t_mask = np.asarray(j_mask)[0] > 0, t_mask.numpy()[0] > 0
    margin = np.minimum.reduce([_frame_margin(j_uv, m, faces, fo, pp, 64, 64)
                                for m, fo, pp in zip(meshes, focals, princpts)])
    tie = (j_fi != t_fi) | (margin < 1e-4)  # a flipped UV face, or a frame's threshold
    assert (j_mask == t_mask)[~tie].all(), np.argwhere((j_mask != t_mask) & ~tie)
    assert j_mask.mean() > 0.05 and (j_mask & ~tie).mean() > 0.05, (j_mask.mean(), tie.mean())
    both = j_mask & t_mask & (j_fi == t_fi)
    np.testing.assert_allclose(t_tex.numpy()[:, both], np.asarray(j_tex)[:, both], atol=1e-5)


def test_render_mesh_overlay(twin, monkeypatch):
    """The head over a 32x32 image: the winning face of every pixel equal,
    the blended image within 1e-6."""
    # the JAX overlay's rasterizer jitted (eager, each small operation compiles)
    j_raster = jax.jit(j_rasterize_mesh, static_argnums=(4,))
    monkeypatch.setattr(j_vis, "rasterize_mesh", j_raster)
    jf, tf = twin["jf"], twin["tf"]
    verts = np.asarray(jf.v_template) + np.asarray([0.0, 0.0, 0.5], np.float32)
    img = np.random.default_rng(9).uniform(size=(32, 32, 3)).astype(np.float32)
    focal, princpt = np.asarray([1.0, 1.0], np.float32) * 60, np.asarray([16.0, 16.0], np.float32)
    want = j_vis.render_mesh_overlay(img, jnp.asarray(verts), jf.faces, focal, princpt)
    got = t_render_mesh_overlay(img, torch.from_numpy(verts), tf.faces.numpy(), focal, princpt)
    j_pf = np.asarray(j_raster(jnp.asarray(verts), jf.faces, jnp.asarray(focal),
                               jnp.asarray(princpt), (32, 32)).pix_to_face)
    t_pf = t_rasterize_mesh(torch.from_numpy(verts), tf.faces, torch.from_numpy(focal),
                            torch.from_numpy(princpt), (32, 32)).pix_to_face.numpy()
    np.testing.assert_array_equal(t_pf, j_pf)
    assert (j_pf >= 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_l1_gradient_at_zero_is_jaxs():
    """``jnp.abs`` has derivative +1 at 0 and ``torch.abs`` 0: the joint offset
    symmetry term (avatar and fitting) at the zero offsets a subject starts
    from gives JAX's gradient (every fitting L1 term takes the same
    ``abs_as_jax``)."""
    from exavatar_release_tpu.avatar.losses import joint_offset_symmetric_reg as j_reg
    from exavatar_release_tpu.avatar.losses import symmetric_joint_pairs
    from exavatar_release_tpu_torch.avatar.losses import joint_offset_symmetric_reg as t_reg

    r, l = symmetric_joint_pairs()
    off = np.zeros((55, 3), np.float32)
    off[r[0]] = [0.01, 0.02, -0.03]  # one pair off zero, the rest at the kink
    want = np.asarray(jax.jit(jax.grad(lambda o: j_reg(o, jnp.asarray(r), jnp.asarray(l))))(
        jnp.asarray(off)))
    t_off = torch.from_numpy(off).requires_grad_(True)
    (got,) = torch.autograd.grad(t_reg(t_off, torch.from_numpy(r), torch.from_numpy(l)), [t_off])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    assert np.abs(want[l[1]]).sum() > 0  # a pair at zero still has JAX's gradient
