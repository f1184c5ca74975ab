"""Planner-only example (counterpart of the JAX package's
``examples/boundplanner_example.py``; ref `boundplanner_example.py`): plan
the example scene with `planner.BoundPlanner` and print the via points.

    python -m boundplanner_tpu_torch.examples.boundplanner_example [--device cpu] [--dtype float64] [--plot]
"""

import argparse
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..planner import BoundPlanner
from ..utils.device import DEFAULT_DEVICE
from .scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles


def main(plot: bool = False, seed: int = 0, device=DEFAULT_DEVICE, dtype=torch.float32):
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=example_obstacles(),
        workspace_max=WORKSPACE_MAX,
        workspace_min=WORKSPACE_MIN,
        seed=seed,
        verbose=True,
        device=device,
        dtype=dtype,
    )
    p0 = np.array([0.3, 0.0, 0.7])
    p1 = np.array([0.45, -0.5, 0.2])
    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    start = time.time()
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    print(f"Path planning took {time.time() - start:.2f}s")
    print("Via points:")
    for p in p_via:
        print("  ", np.round(p, 4))

    if plot:
        import matplotlib.pyplot as plt

        from ..viz import plot_via_path

        plot_via_path(p_via, r_via, sets_via, planner.obs_sets)
        plt.show()
    return p_via, r_via, bp1_list, sets_via


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", action="store_true")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(plot=args.plot, seed=args.seed, device=args.device, dtype=getattr(torch, args.dtype))
