"""ECO-LLM core: the paper's contribution as a composable PyTorch library.

Two subsystems (paper §3):
  * Emulator — path-space exploration with Stratified Budget Allocation,
    prefix caching, and per-(query, path) metric collection.
  * Runtime — Critical Component Analysis, Domain-Specific Query Encoding
    (projection + prototypes trained with contrastive/diversity/reg losses),
    and Runtime Path Selection under SLO constraints.
"""
from repro_torch.core.paths import PathSpace, Path  # noqa: F401
from repro_torch.core.pipeline import BatchedPipelineExecutor, PipelineExecutor  # noqa: F401
from repro_torch.core.emulator import Emulator, EvalTable  # noqa: F401
from repro_torch.core.cca import critical_component_analysis  # noqa: F401
from repro_torch.core.dsqe import DSQE, train_dsqe  # noqa: F401
from repro_torch.core.rps import RuntimePathSelector  # noqa: F401
from repro_torch.core.slo import SLO  # noqa: F401
