"""CUDA-graph replay of a device function: the port's counterpart of the
JAX package's ``jax.jit`` (of ``mpc_tick``, and of the planner's device
functions).

A `Graph` holds one input signature of a function of trees of tensors
(the shapes, dtypes and device of every input leaf; its owner keys its
graphs also by the function and its static arguments, as ``jax.jit``
keys its traces): static input buffers, one captured
``torch.cuda.CUDAGraph`` and its static outputs. `FleetMPC` keeps one per
tick function, configuration and signature; the planner one per kernel
key, static arguments and signature, shared by the whole process
(`planner.planner.device_call`).

- The first call warms up on a side stream: one eager run of the
  function on the static inputs, which builds the kernels, sets kernel
  A's shared-memory attribute and sets up that stream's cuBLAS
  workspace. Its result is the call's result. Then the function is
  captured on the same stream into a private memory pool.
- Every later call copies the caller's inputs into the static inputs,
  replays the graph, and returns clones of the static outputs: the caller
  keeps value semantics (the escalation retry reuses the pre-tick carry).
- A capture or replay that fails raises; nothing falls back to the eager
  route.

Threads: a lock per graph is held across copy-in, replay and clone-out
(two broker leaders of one key and width share the static buffers), and
one capture lock per card across warm-up and capture (one capture uses
the side stream at a time). Lock order: a graph's lock, then the capture
lock, then `ops.sqp._TRANSFORMS` (taken inside the via-rotation SQP's
body); never the other way round. No lock of this module is held across
anything but the call itself, so none is held across a broker's wait.

The kernel wrappers count their launches in Python, which a replay does
not run. A capture launches nothing: it records how many launches of each
counted wrapper (`WRAPPERS`) the graph holds and takes them back off the
counters; each replay adds them again, under the capture lock, so that no
replay's count lands inside another thread's capture.

On the CPU there is nothing to capture: a `Graph` of CPU tensors runs
its body eagerly (copy-in, the function on the static inputs, clone-out),
the CPU tests' view of what the card replays.

`StepGraph` is the JAX package's ``lax.scan``: one graph of a scan's
body, replayed once a step, whose state stays in the graph's static
buffers from step to step (`mpc.bound_mpc.FleetMPC.step_graph`, the
closed-loop rollouts of `parallel.batch` and `gates.rollout_diag`).
`device_cond` is ``lax.cond`` inside such a body: under the capture its
branch becomes a conditional (IF) node of the graph, which a replay runs
only where the predicate on the card holds; the host reads nothing. A
captured branch's launches are counted apart (``branch_launches``): its
owner adds them once for each replay whose predicate held, from a count
the body keeps on the card and the owner reads after the scan. The
warm-up runs a branch whatever its predicate, and its launches count
where they ran, as every eager launch does.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from .. import telemetry
from ..ops._build import check, library
from ..ops.cuda_proj import line_polytope_projection
from ..ops.linalg import kkt_gram, kkt_inverse
from ..utils.tree import tree_map

# the wrappers whose ``launches`` a replay adds to (the functions
# themselves: a caller that swaps a module's name for another route still
# reads the counts here), and their kernels' names
WRAPPERS = (kkt_inverse, line_polytope_projection, kkt_gram)
COUNTED = ("chol_inverse", "line_polytope", "kkt_gram")


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def signature(tree) -> tuple:
    """The shapes, dtypes and devices of a tree's tensor leaves."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(tree))


_SIDE_STREAMS: dict = {}
_BRANCH_STREAMS: dict = {}
_CAPTURE_LOCKS: dict = {}
_SETUP = threading.Lock()


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream per card, so that a capture finds the
    cuBLAS workspace that its warm-up set up."""
    with _SETUP:
        stream = _SIDE_STREAMS.get(device.index)
        if stream is None:
            stream = _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
        return stream


def capture_lock(device: torch.device) -> threading.RLock:
    """The card's capture lock (see the module's lock order)."""
    with _SETUP:
        return _CAPTURE_LOCKS.setdefault(device.index, threading.RLock())


def _reserved(device) -> int:
    return torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)


_BRANCHES = threading.local()


class _Branches:
    """What `device_cond` hands the graph around it: the counted launches
    (per `COUNTED` kernel) that its captured branches record, the graphs
    captured for their IF nodes (whose pools hold the branches' memory),
    and the predicates of the branches that ran outside a capture."""

    def __init__(self):
        self.launches = [0] * len(WRAPPERS)
        self.graphs = []
        self.preds = []


@contextlib.contextmanager
def _branches():
    """Collects, on this thread, the `_Branches` of every `device_cond`
    run or captured inside it."""
    outer = getattr(_BRANCHES, "got", None)
    _BRANCHES.got = got = _Branches()
    try:
        yield got
    finally:
        _BRANCHES.got = outer


def branch_stream(device: torch.device) -> torch.cuda.Stream:
    """The card's stream that `device_cond` captures its branches on."""
    with _SETUP:
        stream = _BRANCH_STREAMS.get(device.index)
        if stream is None:
            stream = _BRANCH_STREAMS[device.index] = torch.cuda.Stream(device)
        return stream


def _capture_if_node(pred: torch.Tensor, body) -> torch.cuda.CUDAGraph:
    """Capture ``body()`` apart, into a graph of its own (kept, not
    instantiated; its own memory pool), on the branch stream; then append
    to the graph that the current stream is capturing an IF node on
    ``pred`` that holds a copy of it (``csrc/graph_cond.cu``). Returns
    the branch's graph, which must live as long as the enclosing one."""
    branch = torch.cuda.CUDAGraph(keep_graph=True)
    parent = torch.cuda.current_stream(pred.device)
    with torch.cuda.stream(branch_stream(pred.device)):
        branch.capture_begin(capture_error_mode="thread_local")
        try:
            body()
        finally:
            branch.capture_end()
    check(library().bp_graph_add_if(parent.cuda_stream, pred.data_ptr(),
                                    branch.raw_cuda_graph()), "graph_add_if")
    return branch


def device_cond(pred: torch.Tensor, body) -> None:
    """``lax.cond(pred, body, no-op)`` for a ``body()`` that writes only
    into tensors allocated before it (so none that it allocates outlives
    it). ``pred`` is a 0-dim bool tensor on the body's device.

    Under a CUDA graph's capture the body becomes an IF node of the graph
    (`_capture_if_node`): a replay runs it only where ``pred`` holds, and
    the host reads nothing. The counted launches that the capture records
    are taken off the wrappers' counts and handed to the enclosing graph
    (``branch_launches``), whose owner adds them once for each replay
    whose ``pred`` held. There is no fallback: a capture that cannot add
    the node raises.

    Outside a capture (a graph's eager warm-up, the CPU) the body runs
    every time, so where ``pred`` is false it must leave its outputs as
    they were; the warm-up builds its kernels before the capture. Its
    launches stay counted, since they ran; ``pred`` goes to the enclosing
    graph, which tells from it the runs that its count of firings holds."""
    got = getattr(_BRANCHES, "got", None)
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        body()
        if got is not None:
            got.preds.append(pred)
        return
    before = [w.launches for w in WRAPPERS]
    try:
        branch = _capture_if_node(pred, body)
    finally:
        for i, (w, b) in enumerate(zip(WRAPPERS, before)):
            if got is not None:
                got.launches[i] += w.launches - b
            w.launches = b
    if got is not None:
        got.graphs.append(branch)


class Graph:
    """One signature of ``fn(*inputs) -> outputs`` (trees of tensors),
    replayed from a CUDA graph on the card. ``launches`` (per `COUNTED`
    kernel; ``branch_launches`` those of its captured `device_cond`
    branches, once per replay whose predicate held), ``capture_s`` and
    ``pool_bytes`` (the card memory the capture reserved) describe the
    graph once captured; ``replays`` counts its replays. The capture is
    the span ``graph.capture`` (``capture_s`` its duration) and each replay
    (launch and clones) the span ``graph.replay`` (`telemetry`)."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.static_in = tree_map(torch.empty_like, inputs)
        self.device = leaves(self.static_in)[0].device
        self.lock = threading.Lock()
        self.graph = None
        self.static_out = None
        self.launches = None
        self.branch_launches = None
        self.branches = []
        # the warm-up's branch runs whose predicate held and did not, not
        # yet set against a count of firings (`add_branch_launches`)
        self._warm_fired = self._warm_idle = 0
        self.capture_s = None
        self.pool_bytes = None
        self.replays = 0

    def _copy_in(self, inputs):
        tree_map(lambda dst, src: dst.copy_(src), self.static_in, inputs)

    def __call__(self, *inputs):
        with self.lock:
            self._copy_in(inputs)
            return self._run()

    def _run(self):
        """``fn`` on the static inputs, clones of its outputs: on the CPU
        eagerly; on the card the first time warm-up and capture, then a
        replay."""
        if self.device.type != "cuda":
            # nothing is captured: every launch counts where it runs
            self.branch_launches = [0] * len(WRAPPERS)
            return tree_map(torch.clone, self.fn(*self.static_in))
        with torch.cuda.device(self.device):
            if self.graph is None:
                return self._warm_up_and_capture()
            with telemetry.span("graph.replay"):
                self.graph.replay()
                with capture_lock(self.device):
                    for wrapper, n in zip(WRAPPERS, self.launches):
                        wrapper.launches += n
                self.replays += 1
                return tree_map(torch.clone, self.static_out)

    def add_branch_launches(self, fired: int) -> int:
        """Count the launches of the graph's captured branches in a run of
        it whose branches fired ``fired`` times: once for each firing in a
        replay (the warm-up's branches ran eagerly and counted their own).
        Returns the warm-up's branch runs whose predicate did not hold,
        whose launches the counts hold beside those of the firings."""
        with capture_lock(self.device):
            replayed, idle = fired - self._warm_fired, self._warm_idle
            self._warm_fired = self._warm_idle = 0
            for wrapper, n in zip(WRAPPERS, self.branch_launches):
                wrapper.launches += n * replayed
        return idle

    def _warm_up_and_capture(self):
        with capture_lock(self.device):
            current = torch.cuda.current_stream(self.device)
            side = side_stream(self.device)
            side.wait_stream(current)
            try:
                # the branches run here whatever their predicates
                with torch.cuda.stream(side), _branches() as warm:
                    first = self.fn(*self.static_in)
            finally:
                current.wait_stream(side)
            result = tree_map(torch.clone, first)
            del first

            before = [w.launches for w in WRAPPERS]
            torch.cuda.synchronize(self.device)
            # which of them fired, read once the card is idle
            held = int(torch.stack(warm.preds).sum()) if warm.preds else 0
            self._warm_fired, self._warm_idle = held, len(warm.preds) - held
            # the capture empties the allocator's cache first; so does this,
            # for the reserved bytes to grow by the private pool alone
            torch.cuda.empty_cache()
            reserved = _reserved(self.device)
            with telemetry.span("graph.capture") as capture:
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"), \
                            _branches() as got:
                        static_out = self.fn(*self.static_in)
                finally:
                    self.launches = [w.launches - b for w, b in zip(WRAPPERS, before)]
                    for w, b in zip(WRAPPERS, before):
                        w.launches = b
                torch.cuda.synchronize(self.device)
            self.capture_s = capture.duration
            self.pool_bytes = _reserved(self.device) - reserved
            self.graph, self.static_out = graph, static_out
            self.branch_launches, self.branches = got.launches, got.graphs
            return result

    def stats(self) -> dict:
        first = leaves(self.static_in)[0]
        floats = [t.dtype for t in leaves(self.static_in) if t.is_floating_point()]
        return {"batch": int(first.shape[0]) if first.dim() else None,
                "dtype": str(floats[0]).split(".")[-1] if floats else None,
                "launches": dict(zip(COUNTED, self.launches or (0,) * len(COUNTED))),
                "branch_launches": dict(zip(COUNTED,
                                            self.branch_launches or (0,) * len(COUNTED))),
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays}


class StepGraph(Graph):
    """One signature of a scan's body ``step(state, const) -> (state',
    record)`` (trees of tensors), replayed once a step: the state stays in
    the graph's static buffers (``static_in[0]``), since the graph ends by
    copying ``state'`` into them; ``const`` is copied in once a scan. A
    step is one replay and the clones of the record. The first step of the
    first scan warms up and captures as `Graph` does (the warm-up is that
    step)."""

    def __init__(self, step, state, const):
        def body(state, const):
            new, record = step(state, const)
            tree_map(lambda dst, src: dst.copy_(src), state, new)
            return record

        super().__init__(body, (state, const))

    def scan(self, state, const, length: int):
        """``length`` steps from ``state``: (the final state, the list of
        records). Nothing between the first step and the last waits for
        the card."""
        with self.lock:
            self._copy_in((state, const))
            records = [self._run() for _ in range(length)]
            return tree_map(torch.clone, self.static_in[0]), records


_UNSET = {torch.empty, torch.empty_like, torch.empty_strided, torch.Tensor.new_empty,
          torch.Tensor.new_empty_strided}


class _Fingerprints(TorchFunctionMode):
    """Records, for every tensor that a torch call returns (but the
    uninitialised ones of ``empty*``), the sum and absolute sum of its
    finite entries and the count of the others, in float64, beside the
    call's name. Under a capture the records are captured too, and a replay
    fills them. Calls inside a ``torch.func`` transform (``vmap``, ``jvp``)
    are not recorded: their tensors do not leave it; the first call after
    it that reads its results shows a difference made inside."""

    def __init__(self):
        super().__init__()
        self.names, self.prints = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _UNSET or torch._C._functorch.peek_interpreter_stack() is not None:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                d = t.detach().to(torch.float64)
                fin = torch.isfinite(d)
                d = torch.where(fin, d, 0.0)
                self.prints.append(torch.stack([d.sum(), d.abs().sum(),
                                                (~fin).sum().to(torch.float64)]))
                self.names.append(getattr(func, "__qualname__", str(func)))
        return out


def first_difference(fn, inputs):
    """The first op whose outputs differ between an eager run of
    ``fn(*inputs)`` and a replay of its capture, on the card: None when
    every op agrees, else {"index", "op", "eager", "graph"} (the op's
    fingerprint in each route: sum, absolute sum, non-finite count), or
    the first op where the two runs' op sequences part. A diagnostic: the
    capture's own launches are taken back off the counters."""
    device = leaves(inputs)[0].device
    eager, eager_in = _Fingerprints(), tree_map(torch.clone, inputs)
    with torch.no_grad(), eager:
        fn(*eager_in)
    replayed, static_in = _Fingerprints(), tree_map(torch.clone, inputs)
    before = [w.launches for w in WRAPPERS]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    try:
        # ``got`` keeps the pools of ``fn``'s IF nodes while it replays
        with torch.no_grad(), torch.cuda.graph(graph, stream=side_stream(device),
                                                capture_error_mode="thread_local"), \
                _branches() as got:
            with replayed:
                fn(*static_in)
    finally:
        for w, b in zip(WRAPPERS, before):
            w.launches = b
    graph.replay()
    torch.cuda.synchronize(device)
    for i, (name_e, name_g) in enumerate(zip(eager.names, replayed.names)):
        a, b = eager.prints[i], replayed.prints[i]
        if name_e != name_g or not torch.equal(a, b):
            return {"index": i, "op": name_e, "graph_op": name_g,
                    "eager": a.tolist(), "graph": b.tolist()}
    if len(eager.names) != len(replayed.names):
        i = min(len(eager.names), len(replayed.names))
        return {"index": i, "op": "end of one run", "eager_ops": len(eager.names),
                "graph_ops": len(replayed.names)}
    return None
