"""``tick_host_ms.arm``: ``BoundMPC.step``'s host work a period (the
``tick`` span less its ``tick.wait``), the median over the run's
periods, in ms. See ``benchmark/phase_readers.py``."""

from benchmark import phase_readers as pr


def read(run):
    return pr.tick_host_ms(pr.program_spans())
