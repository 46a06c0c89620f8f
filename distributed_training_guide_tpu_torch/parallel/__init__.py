from .mesh import AXIS_NAMES, make_mesh, mesh_shape_for
from .plans import STRATEGIES, ShardingPlan, make_plan, spec_for_leaf

__all__ = ["AXIS_NAMES", "make_mesh", "mesh_shape_for", "ShardingPlan",
           "make_plan", "STRATEGIES", "spec_for_leaf"]
