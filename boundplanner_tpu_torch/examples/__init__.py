"""Runnable examples of the port (counterparts of the JAX package's
``examples/``): ``python -m boundplanner_tpu_torch.examples.<name>``, each
with ``--device`` (the card by default; ``--device cpu`` on a machine
without one)."""
