from repro_torch.kernels.dsqe_score.ops import dsqe_score  # noqa: F401
