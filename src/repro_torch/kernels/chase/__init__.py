from .kernel import chase_grid, chase_route, chase_shard, chase_shard_op
from .ref import chase_shard_ref

__all__ = ["chase_grid", "chase_route", "chase_shard", "chase_shard_op", "chase_shard_ref"]
