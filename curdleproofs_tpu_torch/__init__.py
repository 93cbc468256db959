"""curdleproofs_tpu_torch: the PyTorch/CUDA port of the JAX package beside it.

Same module names as the JAX package so a reader finds the counterpart:
`fields` and `curve` are the exact host arithmetic (the pure-Python oracle
and the native host backend), `transcript` the Fiat-Shamir oracle,
`vectors` and `protocol` the shuffle argument and the Whisk API, `ops`
the tensor code and the hand-written CUDA kernels, `utils` the device
resolution, the native host library, the lockstep batch prover and call
metrics. Entry points run on the GPU unless the caller passes device="cpu".
"""
from curdleproofs_tpu_torch.curve import G1, G1_GENERATOR, G1_IDENTITY
from curdleproofs_tpu_torch.fields import CURVE_ORDER, FQ_MOD, FR_MOD, Fr
from curdleproofs_tpu_torch.ops.msm import msm, msm_ladder, msm_ladder_segmented
from curdleproofs_tpu_torch.ops.vector import (
    add_points,
    fold_points,
    fold_points_multi,
    scale_points,
    scale_points_common,
)
from curdleproofs_tpu_torch.protocol import *  # noqa: F401,F403  (the Whisk API and the proofs)
from curdleproofs_tpu_torch.protocol import __all__ as _protocol_all

__version__ = "0.1.0"  # the JAX package's

__all__ = _protocol_all + [
    "CURVE_ORDER",
    "FQ_MOD",
    "FR_MOD",
    "Fr",
    "G1",
    "G1_GENERATOR",
    "G1_IDENTITY",
    "__version__",
    "add_points",
    "fold_points",
    "fold_points_multi",
    "msm",
    "msm_ladder",
    "msm_ladder_segmented",
    "scale_points",
    "scale_points_common",
]
