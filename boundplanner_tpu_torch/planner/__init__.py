from .set_finder import (
    ObstacleArrays,
    build_obstacle_arrays,
    find_set_line,
    find_set_around_point,
)
from .planner import BoundPlanner

__all__ = [
    "ObstacleArrays",
    "build_obstacle_arrays",
    "find_set_line",
    "find_set_around_point",
    "BoundPlanner",
]
