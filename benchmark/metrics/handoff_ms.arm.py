"""``handoff_ms.arm``: a plan's hand-off (``MPCNode.update_reference``, the
span ``node.handoff``), the median over the run's hand-offs, in ms. See
``benchmark/phase_readers.py``."""

from benchmark import phase_readers as pr


def read(run):
    return pr.named_median_ms(pr.program_spans(), "node.handoff")
