from repro_torch.kernels.rglru_scan.ops import rglru_scan_op  # noqa: F401
