"""The plain references that decide ``correct``: ``bmpc`` (the frozen tick),
``fleet`` (the fleet's rollout and its comparison) and ``arm`` (the single
arm's period and its comparison)."""
