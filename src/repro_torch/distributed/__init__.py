"""The distributed layer: activation constraints (``api``), the sharding
policy (``sharding``) and elastic re-meshing (``fault_tolerance``)."""
