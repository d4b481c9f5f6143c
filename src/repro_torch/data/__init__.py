from repro_torch.data.pipeline import ByteTokenizer, TokenPipeline  # noqa: F401
