"""A guard against host data and host reads inside a function that a CUDA
graph is to hold, on the CPU; shared by ``test_torch_graph.py`` (the
tick) and ``test_torch_planner_graph.py`` (the planner's device
functions).

Inside ``host_guard()`` these raise `HostOpError` (a captured graph would
bake the one in and cannot do the other): ``torch.tensor``,
``torch.as_tensor``/``asarray`` of non-tensor data, ``torch.from_numpy``,
``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
``tolist``, ``cpu``, ``numpy``, and any tensor made from Python data on the
way (``aten.lift_fresh``: an index list, a Python scalar assigned into a
tensor, each a host-to-card copy on the card).
"""

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from boundplanner_tpu_torch.ops import qp as tqp

_T = torch.Tensor
HOST_OPS = {_T.item, _T.__bool__, _T.__int__, _T.__float__, _T.__index__, _T.tolist,
            _T.cpu, _T.numpy, torch.tensor}


class HostOpError(RuntimeError):
    pass


class _HostGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in HOST_OPS or (func in (torch.as_tensor, torch.asarray)
                                and not isinstance(args[0], torch.Tensor)):
            raise HostOpError(getattr(func, "__qualname__", str(func)))
        return func(*args, **(kwargs or {}))


class _HostDataGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("lift_fresh", "lift_fresh_copy"):
            raise HostOpError(f"{func}: a tensor made from host data")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_guard():
    """Raise `HostOpError` on any op of ``HOST_OPS`` and on any tensor made
    from host data (``torch.from_numpy``, which no torch-function mode
    sees, is swapped out meanwhile). Where the card launches kernel A (one
    launch in its graph), a library factorization stands in, unguarded:
    the plain version's column loop would only slow the guard down."""
    real_from_numpy, real_kkt = torch.from_numpy, tqp.kkt_inverse

    def refuse(*_):
        raise HostOpError("from_numpy")

    def kernel_a(k):
        with _disable_current_modes(), torch._C.DisableTorchFunction():
            eye = torch.eye(k.shape[-1], dtype=k.dtype).expand_as(k)
            return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(k)[0], eye,
                                                 upper=False)

    torch.from_numpy, tqp.kkt_inverse = refuse, kernel_a
    try:
        with _HostGuard(), _HostDataGuard():
            yield
    finally:
        torch.from_numpy, tqp.kkt_inverse = real_from_numpy, real_kkt
