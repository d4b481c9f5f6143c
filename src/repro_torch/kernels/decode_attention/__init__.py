from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
