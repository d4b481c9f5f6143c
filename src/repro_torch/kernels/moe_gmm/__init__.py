from repro_torch.kernels.moe_gmm.ops import moe_gmm  # noqa: F401
