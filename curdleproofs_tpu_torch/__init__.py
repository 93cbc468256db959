"""curdleproofs_tpu_torch: the PyTorch/CUDA port of the JAX package beside it.

Same module names as the JAX package so a reader finds the counterpart:
`fields` and `curve` are the exact host arithmetic (and the oracle), `ops`
holds the tensor code and the hand-written CUDA kernels, `utils` the device
resolution and call metrics. Entry points run on the GPU unless the caller
passes device="cpu".
"""
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops.msm import msm

__all__ = ["Fr", "G1", "msm"]
