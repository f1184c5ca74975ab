"""``ocp_device_ms.f64``: the OCP evaluation and Jacobians' device time a
tick (the ``ocp`` phase), in the float64 fleet's traced rollout. See
``benchmark/phase_readers.py``."""

from benchmark.phase_readers import phase_device_ms


def read(run):
    return phase_device_ms(run, "ocp")
