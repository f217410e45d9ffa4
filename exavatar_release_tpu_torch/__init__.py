"""exavatar_release_tpu_torch — the PyTorch/CUDA port of exavatar_release_tpu.

The JAX package beside it is the reference; this package mirrors its
subpackage layout so each module's counterpart is found under the same
path. It imports ``torch`` and numpy only, never ``jax`` and nothing of the
JAX package. Every Pallas TPU kernel on a ported path becomes a CUDA C++
kernel for Hopper (``csrc/``), built with nvcc at first use and bound with
ctypes; each has a plain PyTorch twin that CPU tensors run through.

Subpackages (ported so far: the animate render path and the differentiable
frame, i.e. one train step up to its gradients)
-----------
core      : rotations, cameras, geometry, spherical harmonics
models    : SMPL-X body model (LBS, FK, subdivision, prior, synthetic assets)
nn        : Linear -> GroupNorm -> ReLU MLP
ops       : grid sampling, KNN, the differentiable 3DGS rasterizer and its
            kernels, the face-mesh rasterizer, SSIM/PSNR, LPIPS
avatar    : human and scene Gaussians, per-frame poses, losses,
            ``forward_frame``, JAX weight import
train     : ``loss_and_grads`` — the loss of one frame and its gradients
apps      : ``render_motion`` — animate a trained avatar with new poses
"""

__version__ = "0.1.0"
