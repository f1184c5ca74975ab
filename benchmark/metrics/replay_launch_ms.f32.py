"""``replay_launch_ms.f32``: one replay of the rollout's step graph on the
host (its launch and the clones of its record, the span
``graph.replay``), the median over the run's replays, in ms. See
``benchmark/phase_readers.py``."""

from benchmark import phase_readers as pr


def read(run):
    return pr.named_median_ms(pr.program_spans(), "graph.replay")
