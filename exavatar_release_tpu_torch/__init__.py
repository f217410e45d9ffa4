"""exavatar_release_tpu_torch — the PyTorch/CUDA port of exavatar_release_tpu.

The JAX package beside it is the reference; this package mirrors its
subpackage layout so each module's counterpart is found under the same
path. It imports ``torch`` and numpy only, never ``jax`` and nothing of the
JAX package. Every Pallas TPU kernel on a ported path becomes a CUDA C++
kernel for Hopper (``csrc/``), built with nvcc at first use and bound with
ctypes; each has a plain PyTorch twin that CPU tensors run through.

Subpackages (ported so far: the animate render path, the differentiable
frame, the whole train step with its trainer loop, the avatar CLIs, the
kernel probes, the real-asset loaders, profiling and the learning check)
-----------
core      : rotations, cameras, geometry, spherical harmonics
models    : SMPL-X and FLAME body models (LBS, FK, subdivision, prior, the
            released files' loaders, synthetic assets)
nn        : Linear -> GroupNorm -> ReLU MLP
ops       : grid sampling, KNN, the differentiable 3DGS rasterizer and its
            kernels (channel-major, pair-major and row-major compositing,
            the row-major kernels' stage probes, the per-tile window build:
            four libraries under ``csrc/``), the face-mesh rasterizer,
            SSIM/PSNR, LPIPS
avatar    : human and scene Gaussians (with densify/prune and the opacity
            reset), per-frame poses, losses, ``forward_frame``, import and
            export of JAX weights and of the whole train state
train     : ``loss_and_grads`` and ``train_step``, Adam with named groups and
            schedules, densification cadence, the rasterizer's capacity
            governor, scene capacity growth, checkpoints in the JAX package's
            npz layout
data      : COLMAP text and the reference's subject directory layout
native    : the threaded PNG decoder and prefetcher (C++, g++ at first use)
utils     : logger and timer, a PNG writer, video export, torch.profiler
            traces and the roofline model, the JAX package's random draw
apps      : the CLIs ``train``, ``test``, ``evaluate`` and ``animate`` on a
            subject directory, with ``train_loop`` and ``render_motion``
tools     : ``kvariants`` and ``win_probe``, the kernel probes;
            ``convergence_demo``, the learning check
"""

__version__ = "0.1.0"
