# Hot spots as hand-written Hopper kernels: online path selection
# (retrieval_topk, dsqe_score) and language-model serving (flash_attention
# for prefill, decode_attention, moe_gmm for the MoE FFN, rglru_scan for the
# recurrent block).  Each op lives in its own package
# (<name>/kernel.py launches the CUDA code in ../csrc, ops.py is the public
# wrapper, ref.py the plain torch version); the shared sentinel, dispatch
# rule and input checks are in common.py, the one CUDA build in build.py,
# and the init/apply stage composition of selection (embed -> retrieve ->
# score -> argmax) in stages.py.
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk  # noqa: F401
