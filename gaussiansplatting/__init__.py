"""3D Gaussian Splatting framework (JAX/XLA/Pallas).

A from-scratch reimplementation of the capability surface of
ctaylo41/GaussianSplatting (Metal/ObjC++) for an accelerator:
device-resident jitted train steps, fixed-shape padded arrays, block-parallel
alpha blending (a fused Pallas-Triton kernel on the GPU), and deterministic
per-Gaussian gradient reduction.  See SURVEY.md.
"""

import jax

# Gaussian covariance projection, the D-SSIM band matmuls and the XLA
# blend path need genuine f32 matmuls: on the GPU a float32 dot may
# otherwise run in TF32 (~3 decimal digits), visible in conics and alpha
# values, and the XLA reference the fused blend is checked against must be
# true f32.  Code that can tolerate lower precision opts in explicitly.
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
