"""CUDA graphs over the port's kernel wrappers, with their launch counts kept true.

A kernel wrapper counts a launch in Python (``<wrapper>.launches``, and by
input or route in ``.cases`` or ``.route_launches``) when it issues its
kernel. Under stream capture the same Python runs once and launches
nothing, and a replay runs no Python at all. :class:`CountedGraph` captures
a function, takes the counts its capture made off again and keeps them as
the graph's launches, and adds them back on every replay. So each counter
stays the number of kernels of its wrapper that actually ran, eagerly or in
a replay.

A capture also keeps alive every GroupNorm workspace buffer its kernels
write (``groupnorm.workspace_buffers``), so that the workspace's growth by a
later eager call never frees memory a replay still writes. A capture or a
replay that fails raises; nothing falls back to eager calls.
"""

from __future__ import annotations

import ctypes
import functools
import re
import tempfile
from pathlib import Path

import torch

__all__ = ["CountedGraph", "counted_wrappers", "launch_counts", "launch_delta", "add_counts",
           "graph_kernel_names"]


def counted_wrappers() -> tuple:
    """Every kernel wrapper of the port that counts its launches."""
    from ldm3d_torch.ops import attention, conv3d, groupnorm

    return (attention.flash_attention_fwd, attention.flash_attention_bwd_dq,
            attention.flash_attention_bwd_dkv, groupnorm.gn_sums, groupnorm.gn_bwd_sums,
            conv3d.conv3d_igemm)


def launch_counts() -> dict:
    """A copy of every wrapper's counters: ``{wrapper name: {"launches": n,
    "cases": {...}, "route_launches": {...}}}`` (the dicts where it has them)."""
    counts = {}
    for fn in counted_wrappers():
        entry = {"launches": fn.launches}
        for attr in ("cases", "route_launches"):
            if hasattr(fn, attr):
                entry[attr] = dict(getattr(fn, attr))
        counts[fn.__name__] = entry
    return counts


def launch_delta(after: dict, before: dict) -> dict:
    """``after - before`` of two :func:`launch_counts`, keeping only the
    cases and routes that moved."""
    delta = {}
    for name, entry in after.items():
        old = before[name]
        d = {"launches": entry["launches"] - old["launches"]}
        for attr in ("cases", "route_launches"):
            if attr in entry:
                d[attr] = {k: n - old[attr].get(k, 0) for k, n in entry[attr].items()
                           if n != old[attr].get(k, 0)}
        delta[name] = d
    return delta


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (from :func:`launch_counts` differences)
    to the wrappers' counters."""
    for fn in counted_wrappers():
        d = delta.get(fn.__name__)
        if d is None:
            continue
        fn.launches += sign * d["launches"]
        for attr in ("cases", "route_launches"):
            table = getattr(fn, attr, None)
            for key, n in d.get(attr, {}).items():
                table[key] = table.get(key, 0) + sign * n
                if attr == "cases" and not table[key]:
                    del table[key]  # an input no kernel ran on is no case


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count their kernels'
    launches on the wrappers. ``debug=True`` keeps the graph's nodes for
    :meth:`debug_dump`."""

    def __init__(self, debug: bool = False):
        self.graph = torch.cuda.CUDAGraph(keep_graph=debug)
        self.debug = debug
        self.launches: dict | None = None
        self._keep: list = []

    def capture(self, fn, pool=None, stream: torch.cuda.Stream | None = None):
        """Capture ``fn()`` (warmed up by the caller: the kernels built, the
        plans made, the workspace grown) and return what it returned, the
        graph's static outputs. The wrappers' counters are left as they were."""
        from ldm3d_torch.ops import groupnorm

        if self.launches is not None:
            raise RuntimeError("this graph has been captured already")
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                out = fn()
        finally:
            self.launches = launch_delta(launch_counts(), before)
            add_counts(self.launches, -1)  # a capture launches nothing
        self._keep = groupnorm.workspace_buffers()
        if self.debug:
            self.graph.instantiate()
        return out

    def replay(self) -> None:
        """Launch the captured kernels on the current stream, and count them."""
        self.graph.replay()
        add_counts(self.launches)

    def pool(self):
        return self.graph.pool()

    def dot(self) -> str:
        """The graph as DOT text (``cudaGraphDebugDotPrint``, verbose): needs
        ``debug=True``, which keeps the captured graph beside its executable."""
        if not self.debug:
            raise RuntimeError("the graph's nodes are kept only with debug=True")
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "graph.dot"
            err = _cudart().cudaGraphDebugDotPrint(
                ctypes.c_void_p(self.graph.raw_cuda_graph()), str(path).encode(), 1)
            if err != 0:
                raise RuntimeError(f"cudaGraphDebugDotPrint failed with cudaError {err}")
            return path.read_text()



@functools.cache
def _cudart() -> ctypes.CDLL:
    """The CUDA runtime PyTorch loaded, with ``cudaGraphDebugDotPrint``'s
    signature (its flag 1 is ``cudaGraphDebugDotFlagsVerbose``)."""
    lib = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    lib.cudaGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
    lib.cudaGraphDebugDotPrint.restype = ctypes.c_int
    return lib


_NODE = re.compile(r'"graph_\d+_node_\d+"\s*\[(.*?)\];\s*$', re.S | re.M)
_MANGLED = re.compile(r"_Z[0-9A-Za-z_]+")
_ID_FIELD = re.compile(r"\{\s*ID\s*\|[^|]*\|\s*([^|}\\\s]+)")


def graph_kernel_names(dot: str) -> list:
    """The kernel of each kernel node of a ``cudaGraphDebugDotPrint`` dump,
    one entry a node, by the name :func:`ldm3d_torch.ops._kernels._kernel_name`
    gives its mangled symbol (``name<args>`` for the port's kernels); a
    node whose symbol is not mangled keeps the name the dump gives."""
    from ldm3d_torch.ops._kernels import _kernel_name

    names = []
    for body in _NODE.findall(dot):
        if "KERNEL" not in body:
            continue
        found = _MANGLED.search(body) or _ID_FIELD.search(body)
        names.append(_kernel_name(found.group(found.re.groups)) if found else "")
    return names
