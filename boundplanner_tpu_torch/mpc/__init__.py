from .bound_mpc import BoundMPC
from .node import MPCNode

__all__ = ["BoundMPC", "MPCNode"]
