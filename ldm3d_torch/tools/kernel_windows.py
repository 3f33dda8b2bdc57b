"""What ``torch.profiler`` windows hold of the port's kernels, beside a CUDA graph's nodes.

The card tests once named the kernels of each call from a profiler window
of 5 calls (CPU and CUDA activities, then a device synchronize), and some
windows held fewer device kernels than calls, or none (``PERF.md``, C8).
This tool opens such windows again and again over a few of those tests'
calls, in three ways:

* ``window``: the tests' window as it was;
* ``margin``: the same window with ``--margin-ms`` of host sleep after it
  opens and before it closes, so that no kernel runs near either edge (a
  profiler that drops device records outside its window, by timestamps
  that disagree with the host's clock, loses the edge kernels first);
* ``graph``: the calls captured in a CUDA graph, its kernel nodes named
  (``ldm3d_torch.ops.graphs.CountedGraph``), which the tests now read.

For each window it records the named kernels, every device kernel, the
host's kernel-launch API records (``cudaLaunch*``, which CUPTI logs apart
from the kernels) and where the device records lie against the host
records (us from the first host record to the first device record, and
from the last device record to the last host record). It prints one JSON
line per (call, way): windows, windows that lost kernels, the first lost
windows, and the offsets' range; then a summary line.

    python -m ldm3d_torch.tools.kernel_windows [--windows 30] [--margin-ms 20]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ldm3d_torch.ops import attention as A
from ldm3d_torch.ops import conv3d as C
from ldm3d_torch.ops import groupnorm as G
from ldm3d_torch.ops.graphs import CountedGraph, graph_kernel_names

CALLS = 5


def _cases() -> dict:
    """name -> (fn, the part of its kernel's name, kernels a call)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qkv = randn(1, 200, 3 * 2 * 64).unflatten(-1, (3, 2, 64)).unbind(2)
    wide = randn(1, 1000, 3 * 256).unflatten(-1, (3, 1, 256)).unbind(2)
    x = randn(1, 64, 32, 32, 32).contiguous(memory_format=torch.channels_last_3d)
    dy = randn(1, 64, 32, 32, 32).contiguous(memory_format=torch.channels_last_3d)
    mean = torch.zeros((1, 64), device="cuda")
    inv = torch.ones((1, 64), device="cuda")
    cx, cw = randn(1, 16, 32, 32, 64), randn(3, 3, 3, 64, 64)
    return {"flash_fwd bf16 (1,200,2,64)": (lambda: A.flash_attention_fwd(*qkv), "flash_fwd", 1),
            "flash_fwd bf16 (1,1000,1,256)": (lambda: A.flash_attention_fwd(*wide), "flash_fwd",
                                              1),
            "gn_sums (1,64,32^3) bf16": (lambda: G.gn_sums(x), "gn_sums", 1),
            "gn_bwd_sums (1,64,32^3) bf16": (lambda: G.gn_bwd_sums(dy, x, mean, inv),
                                             "gn_bwd_sums", 1),
            "conv3d_igemm (1,16,32,32,64) bf16": (lambda: C.conv3d_igemm(cx, cw), "conv3d", 1)}


def _window(fn, part: str, margin_s: float) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    events = prof.events()
    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    host_names = {ev.name for ev in host}
    device = [ev for ev in events if ev.device_type == DeviceType.CUDA
              and ev.name not in host_names and not ev.name.startswith(("Memcpy", "Memset"))]
    rec = {"named": sum(part in ev.name for ev in device), "device": len(device),
           "launch_api": sum(ev.name.startswith("cudaLaunch") for ev in host),
           "host_events": len(host)}
    if host and device:
        rec["first_device_after_first_host_us"] = (min(ev.time_range.start for ev in device)
                                                   - min(ev.time_range.start for ev in host))
        rec["last_host_after_last_device_us"] = (max(ev.time_range.end for ev in host)
                                                 - max(ev.time_range.end for ev in device))
    if rec["named"] != CALLS:
        rec["device_kernels"] = sorted({ev.name[:80] for ev in device})
    return rec


def _graph(fn, part: str) -> dict:
    graph = CountedGraph(debug=True)
    graph.capture(lambda: [fn() for _ in range(CALLS)])
    names = graph_kernel_names(graph.dot())
    graph.replay()
    torch.cuda.synchronize()
    return {"named": sum(part in n for n in names), "device": len(names)}


def _summary(name: str, way: str, records: list, launches: int) -> dict:
    lost = [(i, r) for i, r in enumerate(records) if r["named"] != launches * CALLS]
    line = {"case": name, "way": way, "windows": len(records), "lost_windows": len(lost),
            "first_lost": [{"window": i, **r} for i, r in lost[:4]]}
    for key in ("first_device_after_first_host_us", "last_host_after_last_device_us"):
        vals = [r[key] for r in records if key in r]
        if vals:
            line[key + "_range"] = [min(vals), max(vals)]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30, help="windows of each call, each way")
    ap.add_argument("--margin-ms", type=float, default=20.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_windows needs a CUDA device")
    from ldm3d_torch.ops import _kernels

    _kernels.build_libraries(_kernels.SOURCES)
    cases = _cases()
    for fn, _, _ in cases.values():
        fn()  # load and warm up
    torch.cuda.synchronize()
    totals: dict = {}

    def report(way, records):
        for name, recs in records.items():
            line = _summary(name, way, recs, cases[name][2])
            print(json.dumps(line), flush=True)
            tot = totals.setdefault(way, [0, 0])
            tot[0] += line["windows"]
            tot[1] += line["lost_windows"]

    # the two profiler ways interleaved, window by window, so that a
    # process-wide state hits each alike; then the graphs
    ways = {"window": 0.0, "margin": args.margin_ms / 1e3}
    records = {way: {name: [] for name in cases} for way in (*ways, "graph")}
    for _ in range(args.windows):
        for name, (fn, part, _) in cases.items():
            for way, margin_s in ways.items():
                records[way][name].append(_window(fn, part, margin_s))
    for way in ways:
        report(way, records[way])
    for _ in range(args.windows):
        for name, (fn, part, _) in cases.items():
            records["graph"][name].append(_graph(fn, part))
    report("graph", records["graph"])
    print(json.dumps({"summary": {way: {"windows": w, "lost_windows": n}
                                  for way, (w, n) in totals.items()},
                      "card": torch.cuda.get_device_name(0), "torch": torch.__version__}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
