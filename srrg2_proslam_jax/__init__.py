"""srrg2_proslam_jax — a stereo / RGB-D visual SLAM engine in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
rvp-group/srrg2_proslam (ProSLAM on the srrg2 "Plug-and-Play SLAM"
architecture).  Not a port: the pipeline is re-designed as a dataflow of
pure jitted stages over fixed-capacity device arrays, with descriptor
matching expressed as int8 matmuls, per-landmark filters vmapped over
the whole map, and the host retaining only the frame status machine.

Layout
------
ops/       low-level jittable kernels: SE3, pinhole, features, hamming,
           matching, triangulation, Gauss-Newton, EKF.
models/    pipeline components: frontend adaptors, aligner, merger,
           landmark arena, tracker, local maps, loop closure, pose graph,
           and the top-level GraphSLAM orchestrator.
parallel/  device-mesh sharding: data-parallel frontend, distributed
           normal-equation reduction for BA/PGO.
io/        dataset readers (KITTI/EuRoC/TUM/ICL/Malaga), image loading,
           trajectory export.
metrics/   ATE/RPE evaluation and regression gates.
utils/     typed config system (JSON round-trip), profiling.
"""

__version__ = "0.1.0"

import jax as _jax

# SLAM geometry (EKF innovations, GN normal equations, SE3 chains) needs true
# f32 matmuls: by default the GPU may run f32 dots in TF32 (about three
# decimal digits), which is enough to visibly degrade the landmark filters.
# The hot descriptor-matching matmuls are int8->int32 and exact regardless,
# so this costs nothing there.
_jax.config.update("jax_default_matmul_precision", "highest")
