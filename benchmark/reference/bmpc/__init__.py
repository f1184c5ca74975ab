"""The benchmark's frozen plain reference of the MPC tick.

A copy of the port's tick modules (``config``, ``mpc``, ``ops``, ``path``,
``robot``, ``utils``) as they stood at commit c40b44d, kept here so that a
later change to the program cannot move the reference. What differs from
the port: no CUDA kernel, graph or model class. The KKT factor is the
library's Cholesky and triangular solve (``ops/linalg.py``), the link
sets' closest points the plain Dykstra projection or the exact IPM by
name (``ops/proj.py``, ``planner/obstacles.py``), and the tick's static
structure carries that name as ``link_route``.
"""
