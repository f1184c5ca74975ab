"""The main path's worst attempted violation, replayed on the CPU.

On the H100 the 128-scene x 20-tick main path (``perf_mpc_params()``,
float32) has its largest attempted violation, 258.18, at scene 56, tick
17: a scene whose attempted solves fail every tick from tick 2 on (the
fallback runs; the executed command never carries that violation).
``chip_smoke.py``'s ``worst_tick`` phase saved that scene's carry,
measurement and obstacles before the tick (``boundplanner_tpu_torch/data``;
the card replays it at batch 1 to 258.30). The same tick in jitted JAX in
float32 on the CPU and through the port's CPU route fails the same way:
both attempted violations lie within 5 % of each other and of the card's
(measured: JAX 257.31, the port 257.66), and the carried error count
and warm-start flag agree.
A difference of the f32 solve's basin (fault (e)), not of the port.

The scene is then rolled out from tick 0 on the CPU at batch 1 in float32
(the cached fleet's scene 56), and every state of the port's trajectory
is also ticked by jitted JAX. Tick 0 fails in both (viol ~2e-4; the scene
starts with no previous solution, so a failed iterate is what runs).
Tick 1 is marginal: the port fails it from its own state, where JAX
succeeds; but over 16 copies of that state with one-ulp noise on the
measurement, each package succeeds on some copies and fails on others
(measured, seed 0: JAX 11, the port 13). From tick 2 on, JAX fails from
the port's states as the port does, by violations within 15 % of the
port's (measured over ticks 2-5: within 9 %). So the worst tick is where
a marginal f32 tick led, in either package.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu import checkpoint as jcheckpoint
from boundplanner_tpu.config import perf_mpc_params as jperf
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc.bound_mpc import mpc_tick
from boundplanner_tpu.parallel.batch import batched_mpc_tick
from boundplanner_tpu.planner.set_finder import ObstacleArrays as JObs
from boundplanner_tpu_torch import checkpoint
from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.mpc import bound_mpc as tmpc
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel.batch import _plant_measurement
from boundplanner_tpu_torch.parallel.fleet_cache import load
from boundplanner_tpu_torch.planner.set_finder import ObstacleArrays
from boundplanner_tpu_torch.utils.integration import integrate_jerk_step
from boundplanner_tpu_torch.utils.tree import to_numpy, to_torch, tree_map

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "..", "boundplanner_tpu_torch", "data")
RTOL = 0.05
FLEET128 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache",
                        "fleet_b128_s7_segs4.pkl")
SCENE, TICKS, COPIES = 56, 6, 16
FAIL_RTOL = 0.15


def test_worst_tick_fails_alike_in_jax_and_the_port():
    inp = np.load(os.path.join(DATA, "worst_tick_inputs.npz"))
    meas = {k[5:]: inp[k] for k in inp.files if k.startswith("meas.")}
    obs = {k[4:]: inp[k] for k in inp.files if k.startswith("obs.")}
    assert (int(inp["scene"]), int(inp["tick"])) == (56, 17)
    card = float(inp["viol_card"])

    jc = jax.tree.map(jnp.asarray, jcheckpoint.load_carry(
        os.path.join(DATA, "worst_tick_carry.npz")))
    assert jc.x_prev.dtype == jnp.float32
    jcarry, jout = mpc_tick(jc, {k: jnp.asarray(v) for k, v in meas.items()},
                            JObs(**{k: jnp.asarray(v) for k, v in obs.items()}), jperf())

    one = lambda tree: tree_map(lambda t: t[None], tree)
    carry = checkpoint.load_carry(os.path.join(DATA, "worst_tick_carry.npz"), "cpu",
                                  torch.float32)
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float32)
    tcarry, tout = model.tick(one(carry), one(to_torch(meas, "cpu", torch.float32)),
                              one(to_torch(ObstacleArrays(**obs), "cpu", torch.float32)))

    jviol, tviol = float(jout["viol"]), float(tout["viol"][0])
    msg = f"attempted violation: card {card}, jax {jviol}, port {tviol}"
    print(msg)
    assert not bool(jout["success"]) and not bool(tout["success"][0]), msg
    assert abs(tviol - jviol) <= RTOL * jviol and abs(jviol - card) <= RTOL * card, msg
    assert int(tcarry.error_count[0]) == int(jcarry.error_count), msg
    assert bool(tcarry.has_prev[0]) == bool(jcarry.has_prev), msg


def jax_carry(carry):
    n = to_numpy(carry)
    return jmpc.MPCCarry(jmpc.PathState(*map(jnp.asarray, n.path)), *map(jnp.asarray, n[1:]))


@pytest.fixture(scope="module")
def scene_from_tick_0():
    """The port's f32 trajectory of scene 56 at batch 1: each tick's carry,
    measurement and outputs, and jitted JAX's outputs from the same state."""
    payload = load(FLEET128)
    f32 = lambda a: np.asarray(a).astype(np.float32) if np.asarray(a).dtype.kind == "f" \
        else np.asarray(a)
    carry, q0, obs = tree_map(lambda a: f32(a)[SCENE:SCENE + 1],
                              (payload["carry"], payload["q0"], payload["obs"]))
    carry = tmpc.MPCCarry(tmpc.PathState(*carry.path), *carry[1:])
    carry, q, obs = to_torch((carry, q0, ObstacleArrays(*obs)), "cpu", torch.float32)
    jobs = JObs(*(jnp.asarray(x.numpy()) for x in obs))
    cfg = jperf()
    jtick = jax.jit(lambda c, m, o: batched_mpc_tick(c, m, o, cfg))
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float32)
    zeros = torch.zeros_like(q)
    dq, ddq, jerk, qf = zeros, zeros, zeros, q
    ticks = []
    with torch.no_grad():
        for _ in range(TICKS):
            meas = _plant_measurement(q, dq, ddq, jerk, qf, model.st.chain)
            _, jout = jtick(jax_carry(carry), {k: jnp.asarray(v.numpy()) for k, v in meas.items()},
                            jobs)
            state = (carry, meas)
            carry, out = model.tick(carry, meas, obs)
            ticks.append((state, out, jax.tree.map(np.asarray, jout)))
            q, dq, ddq = integrate_jerk_step(q, dq, ddq, out["dddq"][:, 0], out["dddq"][:, 1],
                                             model.cfg.dt)
            jerk, qf = out["dddq"][:, 1], out["q"][:, -1]
    return ticks, obs, jobs, jtick, model


def test_scene_fails_alike_in_jax_from_the_ports_states(scene_from_tick_0):
    ticks, *_ = scene_from_tick_0
    rows = [(float(out["viol"][0]), bool(out["success"][0]), float(jout["viol"][0]),
             bool(jout["success"][0])) for _, out, jout in ticks]
    msg = "tick: (port viol, ok, jax viol, ok) " + str(rows)
    print(msg)
    assert not rows[0][1] and not rows[0][3] and 1e-4 < rows[0][0] < 1e-3, msg
    assert not rows[1][1] and rows[1][3], msg        # the marginal tick, see the next test
    for pv, pok, jv, jok in rows[2:]:
        assert not pok and not jok, msg
        assert abs(pv - jv) <= FAIL_RTOL * pv, msg


def test_first_failing_tick_is_marginal_in_both(scene_from_tick_0):
    """Tick 1's state in COPIES copies, copy 0 exact, the rest with one-ulp
    noise (seed 0) on every measured value: both packages succeed on some
    copies and fail on others."""
    ticks, obs, jobs, jtick, model = scene_from_tick_0
    (carry, meas), _, _ = ticks[1]
    rng = np.random.default_rng(0)
    noisy = {}
    for key, val in meas.items():
        a = np.repeat(val.numpy(), COPIES, 0)
        u = rng.integers(-1, 2, a.shape).astype(np.float32)
        u[0] = 0
        noisy[key] = (a + u * np.spacing(np.abs(a))).astype(np.float32)
    rep = lambda tree: tree_map(lambda t: t.repeat((COPIES,) + (1,) * (t.dim() - 1)), tree)
    obs_b, carry_b = rep(obs), rep(carry)
    _, jout = jtick(jax_carry(carry_b), {k: jnp.asarray(v) for k, v in noisy.items()},
                    JObs(*(jnp.asarray(x.numpy()) for x in obs_b)))
    with torch.no_grad():
        _, tout = model.tick(carry_b, {k: torch.from_numpy(v) for k, v in noisy.items()}, obs_b)
    j_ok, t_ok = np.asarray(jout["success"]), tout["success"].numpy()
    msg = f"successes of {COPIES}: jax {int(j_ok.sum())} {j_ok.astype(int)}, " \
          f"port {int(t_ok.sum())} {t_ok.astype(int)}"
    print(msg)
    assert 0 < j_ok.sum() < COPIES and 0 < t_ok.sum() < COPIES, msg
