"""Device compute: field limb arithmetic, G1 group ops and the streaming MSM,
as plain PyTorch functions on tensors plus hand-written CUDA kernels
(sources under ../csrc, built at first use)."""
