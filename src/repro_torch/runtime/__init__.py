from repro_torch.runtime.server import EcoLLMServer, Request, Response  # noqa: F401
from repro_torch.runtime.fleet import ReplicaFleet, Replica, FleetFuture  # noqa: F401
from repro_torch.runtime.orchestrator import (  # noqa: F401
    Orchestrator, Overloaded, Ticket)
from repro_torch.runtime.placement import (  # noqa: F401
    PlacementPlan, StagePlan, get_plan, search_placement, simulate_pipeline)
