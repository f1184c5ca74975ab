"""The shared example scene (a copy of the JAX package's ``examples/scene.py``;
ref `boundplanner_example.py:19-92` / `boundplanner_with_mpc_example.py:38-107`)."""


def example_obstacles():
    size = 0.04
    s_box = 0.12
    w_boxx = 0.02
    w_boxy = 0.02
    p_box = [0.45, -0.48, 0.05]
    h_box = 0.18
    return [
        [p_box[0] + s_box - w_boxx, p_box[1] - s_box, 0.0,
         p_box[0] + s_box, p_box[1] + s_box, p_box[2] + h_box],
        [p_box[0] - s_box, p_box[1] - s_box, 0.0,
         p_box[0] - s_box + w_boxx, p_box[1] + s_box, p_box[2] + h_box],
        [p_box[0] - s_box, p_box[1] - s_box - w_boxy, 0.0,
         p_box[0] + s_box, p_box[1] - s_box, p_box[2] + h_box],
        [p_box[0] - s_box, p_box[1] + s_box, 0.0,
         p_box[0] + s_box, p_box[1] + s_box + w_boxy, p_box[2] + h_box],
        [0.2, -1.0, -0.1, 1.0, 1.0, 0.0],
        [-0.3, -1.0, 0.53, 0.2, -0.35, 1.0],
        [-0.2, -1.0, 0.0, -0.14, 1.0, 1.0],
        [-1.0, 0.38, 0.0, 1.0, 0.5, 1.0],
        [0.4, -0.05, 0.0, 0.5, 0.05, 0.15],
        [0.1, -0.55, 0.0, 0.3, -0.35, 0.07],
        [0.5 - size, -0.2 - size, 0.03 - size, 0.5 + size, -0.2 + size, 0.03 + size],
        [0.4 - size, 0.3 - size, 0.03 - size, 0.4 + size, 0.3 + size, 0.03 + size],
    ]

WORKSPACE_MAX = [1.0, 0.38, 1.0]
WORKSPACE_MIN = [-0.14, -1.0, 0.0]
