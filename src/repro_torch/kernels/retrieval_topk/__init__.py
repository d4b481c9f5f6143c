from repro_torch.kernels.retrieval_topk.ops import retrieval_topk  # noqa: F401
