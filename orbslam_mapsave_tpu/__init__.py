"""orbslam_mapsave_tpu — visual SLAM on JAX/XLA, run on an NVIDIA GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
ORB-SLAM2 fork skaegy/ORBSLAM_MapSave (see SURVEY.md at the repo root for
the blueprint and file:line parity citations).
"""

import jax as _jax

# Geometry and optimization need true float32 matmuls: at the default
# precision XLA may run f32 products in TF32 on the GPU's tensor cores
# (about three decimal digits), which breaks pose/BA convergence
# (pixel-level errors) and descriptor parity. Integer matmuls (the Hamming
# popcount products) are unaffected by this setting. Kernels that want
# bf16 opt in explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
