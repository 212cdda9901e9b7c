"""Distribution for the port: sharding rules as DTensor placements
(``rules``), the MoE weight-gather context (``context``) and elastic
restore of committed states onto any layout (``resharding``)."""
from repro_torch.sharding.rules import ShardingRules, Spec

__all__ = ["ShardingRules", "Spec"]
