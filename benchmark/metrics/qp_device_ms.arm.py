"""``qp_device_ms.arm``: the Gram, Hessian and QP solve's device time a
tick (the ``qp`` phase, kernel A inside), in the single arm's traced
periods. See ``benchmark/phase_readers.py``."""

from benchmark.phase_readers import phase_device_ms


def read(run):
    return phase_device_ms(run, "qp")
