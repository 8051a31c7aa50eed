"""plviwo_tpu — a JAX point-line visual-inertial-wheel odometry framework.

A from-scratch JAX/XLA re-design of the capabilities of PL-VIWO
(Happy-ZZX/PL-VIWO, a MINS/OpenVINS-derived sliding-window MSCKF): batched
fixed-shape image ops for point/line front-ends, fused jitted linear algebra
for the EKF filter core, and a `shard_map`-based multi-host layer for
sequence-sharded replay and distributed Schur-complement bundle adjustment.

The filter core runs in float64 (small matrices, ~300x300 covariances);
the image front-end and the per-feature camera tensors run in float32.

Layer map (mirrors SURVEY.md section 1):
  ops/       L0  math substrate: JPL Lie ops, camera models, chi2, image ops
  core/      L2  filter core: state layout, EKF primitives, propagation, interpolation
  update/    L3  measurement updaters: camera (points+lines), wheel, GPS
  init/      L4  state initialization (static IMU, IMU+wheel)
  models/    L4/L5 assembled estimator pipelines (VIO, VIO+L, VIWO, VIWO+GPS)
  sim/       test backend: SE(3) B-spline simulator with synthetic sensors
  data/      L5  dataset readers (KAIST), TUM format IO
  eval/      L7  trajectory alignment + ATE/RPE/NEES metrics
  parallel/  distributed: mesh utils, sequence-sharded replay, Schur BA
  config/    L6  typed config tree + YAML loading
  utils/     L6  logging, timing, recorders
"""

__version__ = "0.1.0"
