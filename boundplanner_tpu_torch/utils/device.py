"""The device check of the port's entry points.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``). A call that names a CUDA device on a machine without
one raises at once, naming the device: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` if it is a
    CUDA device and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def graph_route(graph, device: torch.device) -> bool:
    """Whether an object on ``device`` replays CUDA graphs, from its
    ``graph`` argument: ``None`` (the default) on a CUDA device and not on
    the CPU, ``False`` never; ``True`` raises ``ValueError`` off the card."""
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, not {device}")
    return device.type == "cuda" if graph is None else bool(graph)
