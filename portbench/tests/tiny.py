"""A cell cut to a size the CPU tests can run: the configurations' keys at
toy widths, so every code path of a run is reached."""
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(rel: str) -> dict:
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


def config() -> dict:
    cfg = load("configs/exavatar_1080p_s20k.json")
    cfg.update(image=[64, 256], focal=60.0, smplx_body=dict(cfg["smplx_body"], rings=8, segs=12),
               triplane_ch=8, triplane_res=16, scene_capacity=512, scene_live=300,
               face_texture=16, lpips_net="alex", lpips_crop=[32, 32], train_frames=3,
               motion_poses=6)
    return cfg


def traffic(name: str) -> dict:
    tr = load(f"traffic/{name}.json")
    tr["trace_units"] = 2
    tr["compare_frames"] = 3
    return tr


def args(cell: str, seed: int, trace: int, seconds: float = 1.0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
