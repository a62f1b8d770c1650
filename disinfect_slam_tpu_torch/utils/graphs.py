"""Captured steps: the counterpart of the JAX package's jit cache.

The JAX package runs each per-frame step as one compiled program, the
pose a traced device array and the volume donated (`integrate_jit`,
`TSDFGrid._integrate` / `_splat`, the online step's `_step`).  Eager
torch issues the same step as hundreds of launches.  Here a step is a
closure that reads its inputs from static device buffers (a frame, a
DevicePose) and updates a volume in place, and `StepGraphs.run` runs it
under a key:

  - the first call of a key runs the step eagerly (on the capture stream:
    it is also the warm-up), then captures it as a CUDA graph; capture
    records without running, so nothing is fused twice;
  - every later call of the key replays the graph.

The key holds what jax.jit holds static (image size, intrinsics,
max_depth, allocate, stats on or off, the input slot) and the volume's
`storage_key()` (its config and the address of every tensor), so a
recenter, a restore or a new volume captures anew instead of replaying
into freed memory.

On a CUDA device a capture that fails raises: no step drops to eager by
itself.  On the CPU the step runs eagerly every call, because the caller
asked for the CPU, as a kernel wrapper runs its plain version there.
Capture uses capture_error_mode="thread_local", so a step may be
captured on its own thread (DISINFSystem integrates on one).

The graphs of one StepGraphs share one memory pool: they never run at
the same time (their owner issues them on one stream under its lock),
and an output a caller keeps is copied out before the next replay.

Launch counts: a kernel wrapper adds one to its count where Python runs
it (count_launch), and a capture runs the wrapper without launching
anything, so what a capture adds on its own thread is taken back and
added again at every replay.  REPLAYS counts the replays ("graph") and
the launches they made, by kernel.
"""

from __future__ import annotations

import collections
import gc
import itertools
import os
import re
import tempfile
import threading
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..core.geometry import POSE_FLOATS, SE3, DevicePose, pose_floats

# "graph": graph replays; a kernel wrapper's name: its launches made by them
REPLAYS: collections.Counter = collections.Counter()
# one capture at a time in the process: each turns the garbage collector off
# (a process-wide switch) and collects before it, which must not free a graph
# that another thread is capturing into (the online app segments on its main
# thread while DISINFSystem integrates on its own)
_CAPTURE_LOCK = threading.Lock()
# the launches a capture on this thread records (None outside a capture)
_CAPTURING = threading.local()


def count_launch(fn) -> None:
    """A counted kernel wrapper's launch: one more on fn.launches, and on
    the counts of a capture running on this thread, which takes them back
    (a capture launches nothing) and adds them at each replay.  Launches
    that other threads make meanwhile stay theirs."""
    fn.launches += 1
    counts = getattr(_CAPTURING, "counts", None)
    if counts is not None:
        counts[fn.__name__] += 1


def counted_kernels() -> tuple:
    """The hand kernels' wrappers on the captured paths (each counts its
    launches in `.launches`)."""
    from ..ops.cuda import (fuse_kernel, icp_kernel, pose_graph_kernel, raycast_kernel,
                            sample_kernel, splat_kernel)

    return (fuse_kernel.fuse_rows, sample_kernel.sample_rows,
            splat_kernel.splat_zbuf_blocks, splat_kernel.splat_payload_blocks,
            icp_kernel.icp_step, pose_graph_kernel.pose_graph_solve, raycast_kernel.raycast,
            raycast_kernel.superblock_bits)


def host_image(a) -> np.ndarray:
    """A host image as a step stages it: contiguous, u8 kept, anything else
    as float32 (the cast the step's float32 ops would make)."""
    a = np.asarray(a)
    return np.ascontiguousarray(a if a.dtype == np.uint8 else a.astype(np.float32))


def keep(store: dict, key, *tensors) -> tuple:
    """Copy a step's results into buffers that `store` holds under `key`
    and return those buffers.  A captured step's body ends with this: its
    outputs then live in memory its owner holds, outside the graph's pool,
    and each replay leaves its results there for the caller.  The buffers
    are made on the key's first call, which runs eagerly."""
    bufs = store.get(key)
    if bufs is None:
        bufs = store[key] = tuple(torch.empty_like(t) for t in tensors)
    for b, t in zip(bufs, tensors):
        b.copy_(t)
    return bufs


def tensors_key(tensors) -> tuple:
    """The address, shape and dtype of each tensor (None for None): the
    part of a step's key that holds its storage, so that a tensor replaced
    (a new model, load_state_dict(assign=True), .to(), new optimizer
    state) captures anew instead of replaying into freed memory."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in tensors)


def module_key(module: torch.nn.Module) -> tuple:
    """tensors_key of a module's parameters and buffers."""
    return tensors_key(itertools.chain(module.parameters(), module.buffers()))


class StaticInputs:
    """A step's inputs as static device buffers (`dev`), each filled by a
    copy from a pinned host staging buffer.  There are `slots` staging
    sets, used in turn by the caller, so that the host fills one while the
    device may still copy from another; `fill` waits until the device has
    read the slot's last contents.  specs: {name: (shape, dtype)}; a
    "pose" entry is a DevicePose buffer (`pose`); `buffers` names device
    tensors the copies fill in place of new ones (a 0-d learning rate an
    optimizer reads)."""

    def __init__(self, specs: dict, device, slots: int = 2, buffers: Optional[dict] = None):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        buffers = buffers or {}
        self.dev = {n: buffers[n] if n in buffers else torch.zeros(shape, dtype=dt,
                                                                  device=self.device)
                    for n, (shape, dt) in specs.items()}
        self._host = [{n: torch.zeros(shape, dtype=dt, pin_memory=pin)
                       for n, (shape, dt) in specs.items()} for _ in range(slots)]
        self._read = [None] * slots
        self.pose = DevicePose(self.dev["pose"]) if "pose" in specs else None

    @staticmethod
    def pose_spec() -> tuple:
        return ((POSE_FLOATS,), torch.float32)

    def fill(self, slot: int, **values) -> None:
        """Write host values into the slot's staging: arrays (cast as
        numpy casts them), scalars (broadcast), or an SE3 for "pose"."""
        if self._read[slot] is not None:
            self._read[slot].synchronize()
        for name, v in values.items():
            if isinstance(v, SE3):
                v = pose_floats(v)
            dst = self._host[slot][name]
            if np.isscalar(v):
                dst.fill_(v)
            else:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(v)))

    def upload(self, slot: int, names=None) -> None:
        """The copies from the slot's staging into the device buffers (all,
        or `names`): the first ops of a captured step."""
        for name in self.dev if names is None else names:
            self.dev[name].copy_(self._host[slot][name], non_blocking=True)

    def done(self, slot: int) -> None:
        """Mark the slot as read by the work issued so far."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._read[slot] = ev


def batch_inputs(store: dict, device: torch.device, slot: int, **arrays) -> tuple:
    """A captured step's named arrays in static device buffers, kept in
    `store` by their shapes and dtypes: host arrays (numpy, or CPU tensors
    for a step on another device) as float32 through pinned staging slot
    `slot`, which the step's body uploads first (`inputs.upload(slot)`);
    tensors on a device copied into the buffers now, before the step.
    Returns (inputs, staged, key): the part of the step's key the inputs
    decide (the staging slot among it)."""
    def host(a):
        return not isinstance(a, torch.Tensor) or (a.device.type == "cpu"
                                                    and device.type != "cpu")

    staged = host(next(iter(arrays.values())))
    if any(host(a) != staged for a in arrays.values()):
        raise ValueError("a step's arrays are all on the host or all on a device")
    if staged:
        arrays = {n: np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else a,
                                          dtype=np.float32) for n, a in arrays.items()}
        specs = {n: (tuple(a.shape), torch.float32) for n, a in arrays.items()}
    else:
        specs = {n: (tuple(a.shape), a.dtype) for n, a in arrays.items()}
    key = (staged,) + tuple(specs.items()) + ((slot,) if staged else ())
    shapes = key[:-1] if staged else key
    inputs = store.get(shapes)
    if inputs is None:
        inputs = store[shapes] = StaticInputs(specs, device, slots=2 if staged else 0)
    if staged:
        inputs.fill(slot, **arrays)
    else:
        for n, a in arrays.items():
            inputs.dev[n].copy_(a)
    return inputs, staged, key


# the node types of a CUDA graph's DOT dump (cudaGraphDebugDotPrint)
DOT_NODE_TYPES = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "EMPTY", "GRAPH", "EVENT_RECORD",
                  "WAIT_EVENT", "EXT_SEMAS_SIGNAL", "EXT_SEMAS_WAIT", "MEM_ALLOC", "MEM_FREE",
                  "BATCH_MEM_OP", "CONDITIONAL")


def dot_nodes(text: str) -> collections.Counter:
    """The nodes of a CUDA graph's DOT dump: a Counter of node types, a
    kernel node counted as "KERNEL <its function's mangled name>".  Raises
    on a node with no type, or on no node."""
    # a statement a line: a node ("graph_1_node_0"[...]) or an edge
    # ("graph_1_node_0" -> "graph_1_node_1" [...]), a label running on
    # over lines
    lines = list(re.finditer(r'^"graph_\d+_node_\d+"(\s*\[)?', text, re.MULTILINE))
    type_re = re.compile(r"\b(" + "|".join(DOT_NODE_TYPES) + r")\b")
    nodes = collections.Counter()
    for m, nxt in zip(lines, lines[1:] + [None]):
        if m.group(1) is None:
            continue  # an edge
        block = text[m.start():nxt.start() if nxt is not None else len(text)]
        kind = type_re.search(block)
        if kind is None:
            raise ValueError(f"a node of the DOT dump has no type: {block[:600]!r}")
        if kind.group(1) == "KERNEL":
            fn = re.search(r"_Z\w+", block)
            nodes[f"KERNEL {fn.group(0) if fn else '?'}"] += 1
        else:
            nodes[kind.group(1)] += 1
    if not nodes:
        raise ValueError(f"the DOT dump holds no node: {text[:2000]!r}")
    return nodes


class StepGraphs:
    """A cache of captured steps of one owner, keyed as the module's
    docstring says; at most `max_graphs`, the least recently used going
    first.  `capture(body) -> (replay, outputs)` is the capturer: CUDA
    graphs on a CUDA device, none on the CPU (eager there); a test may
    pass its own.  `keep_structure` keeps each CUDA graph's nodes after
    its capture, for `nodes`."""

    def __init__(self, device, capture: Optional[Callable] = None, max_graphs: int = 8,
                 keep_structure: bool = False):
        self.device = torch.device(device)
        if capture is None and self.device.type == "cuda":
            capture = self._capture_cuda
        self._capture = capture
        self.max_graphs = max_graphs
        self.keep_structure = keep_structure
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._stream = None
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        return list(self._graphs)

    def run(self, key, body: Callable):
        """body() under `key`: eager and then captured on the key's first
        call, replayed after it; returns body's outputs (after a replay,
        the captured ones, valid until the next replay of this cache)."""
        if self._capture is None:
            return body()
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            replay, out, launched = entry
            replay()
            self.replays += 1
            REPLAYS["graph"] += 1
            for fn in counted_kernels():
                fn.launches += launched[fn.__name__]
                REPLAYS[fn.__name__] += launched[fn.__name__]
            return out
        out = self._eager(body)
        counts = collections.Counter()
        _CAPTURING.counts = counts
        try:
            replay, captured = self._capture(body)
        finally:
            _CAPTURING.counts = None
            launched = {fn.__name__: counts[fn.__name__] for fn in counted_kernels()}
            for fn in counted_kernels():
                fn.launches -= launched[fn.__name__]
        self.captures += 1
        self._graphs[key] = (replay, captured, launched)
        while len(self._graphs) > self.max_graphs:
            self._graphs.popitem(last=False)
        return out

    def nodes(self, key) -> collections.Counter:
        """The nodes of the CUDA graph captured under `key`, read from the
        graph itself (its DOT dump, `dot_nodes`), not from a profiler
        trace; needs keep_structure."""
        if not self.keep_structure:
            raise ValueError("StepGraphs.nodes needs keep_structure=True")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "graph.dot")
            with warnings.catch_warnings():  # torch announces each dump
                warnings.simplefilter("ignore", UserWarning)
                self._graphs[key][0].__self__.debug_dump(path)
            if not os.path.exists(path):
                raise RuntimeError("the CUDA graph's DOT dump wrote no file")
            with open(path) as f:
                return dot_nodes(f.read())

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _eager(self, body: Callable):
        """The key's first call: eagerly, on the capture stream on a CUDA
        device (lazy per-stream state, such as cuBLAS workspaces, is made
        there before the capture), ordered with the caller's stream."""
        if self.device.type != "cuda":
            return body()
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body()
        cur.wait_stream(side)
        return out

    def _capture_cuda(self, body: Callable):
        """Capture body() as a CUDA graph in this cache's pool; raises if
        the capture fails (a sync, a host read, an uncapturable call)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # keep_graph: the graph's nodes outlive its instantiation, for nodes()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_structure)
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(self.device)
            # no garbage collection inside the capture: it may free another
            # step's graph (an owner in a reference cycle), and destroying a
            # graph while this thread captures invalidates the capture
            # (torch.cuda.graph collects before it captures too)
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.device(self.device), torch.cuda.stream(side):
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        out = body()
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass  # the capture is already invalid; body's error is the one to raise
                        raise
                    graph.capture_end()
                    if self.keep_structure:
                        graph.instantiate()
            finally:
                if collecting:
                    gc.enable()
        cur.wait_stream(side)
        return graph.replay, out



class RenderStep:
    """A render as one captured step a view (the JAX package's jitted
    renders): the pose in a static buffer, a CUDA graph on a CUDA device
    keyed by (`name`, image size, intrinsics, the render's own arguments,
    where the pose comes from, the volume's storage_key).  An SE3 pose goes
    through pinned staging (one slot: a render waits until the last one
    has read it) and its copy is the step's first op; a DevicePose on the
    device is copied in before the step.  The render's images are written
    into buffers the step holds (`keep`, one set an image size) and come
    back as fresh copies, as the jitted call returns them.  On the CPU the
    render runs eagerly.  A subclass names the step, its `result` type (a
    NamedTuple) and `render(vol, cam, pose, *args)`, which returns one
    whose None fields, if any, come last and keep their defaults."""

    name = "render"
    result: type = tuple

    def __init__(self, device, graphs: Optional[StepGraphs] = None):
        self.device = torch.device(device)
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._inputs = StaticInputs({"pose": StaticInputs.pose_spec()}, self.device, slots=1)
        self._outputs: dict = {}

    def render(self, vol, cam, pose: DevicePose, *args):
        raise NotImplementedError

    def run(self, vol, cam, pose, *args):
        """render(vol, cam, pose, *args) through the step; args are part of
        the key, so hashable."""
        inputs = self._inputs
        staged = isinstance(pose, SE3)
        if staged:
            inputs.fill(0, pose=pose)
        else:
            inputs.dev["pose"].copy_(pose.slots())
        key = (self.name, cam.img_h, cam.img_w, cam.intrinsics) + args + (staged,)
        size = (cam.img_h, cam.img_w)

        def body():
            if staged:
                inputs.upload(0)
            res = self.render(vol, cam, inputs.pose, *args)
            keep(self._outputs, size, *(t for t in res if t is not None))

        self.graphs.run(key + vol.storage_key(), body)
        if staged:
            inputs.done(0)
        return self.result(*(t.clone() for t in self._outputs[size]))
