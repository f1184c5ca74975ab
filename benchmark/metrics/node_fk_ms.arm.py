"""``node_fk_ms.arm``: the node's forward kinematics a period (the
``node.fk`` spans of a ``node.step`` summed), the median over the run's
periods, in ms. See ``benchmark/phase_readers.py``."""

from benchmark import phase_readers as pr


def read(run):
    return pr.node_fk_ms(pr.program_spans())
