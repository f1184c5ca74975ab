"""``qp_device_ms.f64``: the Gram, Hessian and QP solve's device time a
tick (the ``qp`` phase, kernel A inside), in the float64 fleet's traced
rollout. See ``benchmark/phase_readers.py``."""

from benchmark.phase_readers import phase_device_ms


def read(run):
    return phase_device_ms(run, "qp")
