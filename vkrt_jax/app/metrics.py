"""Per-frame metrics + observability.

The reference's only instrumentation is a CPU FPS counter
(ref: src/Raytracer.cpp:213-216) and debug-marker labels for RenderDoc
(ref: src/DebugMarker.cpp). Equivalents here:
  * FrameTimer — wall-clock frame ms, FPS, Mrays/s (the BASELINE metric)
  * named profiler scopes via jax.profiler (trace with `with profile(dir)`)
    and `scope_device_times`, which reduces a trace to device time per
    scope
  * NaN sentinel check (the validation-layer analogue for shading math)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import os
import re
import time
from typing import List

import numpy as np


@dataclasses.dataclass
class FrameStats:
    frame_ms: float
    rays: int

    @property
    def mrays_per_s(self) -> float:
        return self.rays / (self.frame_ms / 1000.0) / 1e6

    @property
    def fps(self) -> float:
        return 1000.0 / self.frame_ms


class FrameTimer:
    """Collects per-frame wall-clock stats (ref FPS counter analogue)."""

    def __init__(self):
        self.frames: List[FrameStats] = []
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self, rays: int) -> FrameStats:
        dt = (time.perf_counter() - self._t0) * 1000.0
        stats = FrameStats(frame_ms=dt, rays=rays)
        self.frames.append(stats)
        return stats

    def summary(self) -> dict:
        if not self.frames:
            return {}
        ms = np.array([f.frame_ms for f in self.frames])
        rays = np.array([f.rays for f in self.frames])
        steady = slice(1, None) if len(ms) > 1 else slice(None)
        return {
            "frames": len(ms),
            "frame_ms_mean": float(ms[steady].mean()),
            "frame_ms_min": float(ms.min()),
            "fps_mean": float(1000.0 / ms[steady].mean()),
            "mrays_per_s": float((rays[steady] / ms[steady]).mean() / 1e3),
            "total_rays": int(rays.sum()),
        }


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """jax.profiler trace scope (DebugMarker/RenderDoc analogue)."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield


def check_finite(fb: np.ndarray, label: str = "framebuffer") -> None:
    """NaN/Inf sentinel (validation-layer analogue)."""
    bad = ~np.isfinite(fb)
    if bad.any():
        raise FloatingPointError(
            f"{label}: {bad.sum()} non-finite values (first at "
            f"{np.argwhere(bad)[0].tolist()})")


# Named scopes of the frame (wavefront/engine.py); an op's scope key joins
# every one of these its HLO op_name path contains, e.g.
# "trace_shadow_d1/group_sort".
SCOPES = re.compile(r"trace_closest_d\d+|trace_shadow_d\d+|group_sort|"
                    r"sample_d\d+")
_HLO_OP = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"')
_COMPUTATION = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$")
_WHILE = re.compile(r'condition=%?([\w.\-]+), body=%?([\w.\-]+).*?'
                    r'op_name="([^"]*)"')


def _scope_key(op_name: str) -> str:
    return "/".join(SCOPES.findall(op_name)) or "other"


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name → scope key, from a compiled module's text
    (`jax.jit(f).lower(...).compile().as_text()`). An instruction inside
    a while loop's condition or body takes the scope of that while op:
    loops that run one traced function get cloned computations whose
    own metadata names the first call site only."""
    own, comp_of, loop_scope = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMPUTATION.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _HLO_OP.match(line)
        if m:
            own[m.group(1)] = _scope_key(m.group(2))
            comp_of[m.group(1)] = comp
        m = _WHILE.search(line)
        if m:
            loop_scope[m.group(1)] = loop_scope[m.group(2)] = \
                _scope_key(m.group(3))
    return {name: loop_scope.get(comp_of[name], sc)
            for name, sc in own.items()}


def _kernel_key(name: str) -> str:
    # GPU kernels carry their HLO instruction's name with '.' and '-'
    # spelled '_' (fusion.12 → fusion_12)
    return re.sub(r"[.\-]", "_", name)


def scope_device_times(trace_dir: str, hlo_text: str) -> dict:
    """Reduce a jax.profiler trace of one module's runs to device time.

    On a GPU every event of the device planes ("/device:...") counts. An
    event outside a CUDA graph names its HLO instruction in `hlo_op` and
    takes that instruction's scope. Kernels inside a CUDA graph (a
    while-loop body: `hlo_op` reads "command_buffer" and the kernel name
    may be one shared by identical fusions) belong to the loop whose
    condition runs next, so they take the scope of the next event
    outside a graph; straight-line code that XLA also runs as a graph is
    counted with the loop that follows it. Without device planes (the
    CPU, where XLA runs ops on host threads) the events that carry an
    `hlo_op` count.

    Returns {"scopes": {scope: ms}, "loops": [(scope, ms, launches)] —
    per op that ends CUDA-graph launches (a while loop's condition, or
    the op after a straight-line graph), in device order, the graphs'
    busy ms and number of launches —,
    "top_ops": [(kernel, ms, count)] (15 largest), "busy_ms",
    "window_ms", "idle_share"}: busy is the union of event intervals,
    the window runs from the first event's start to the last one's end."""
    from jax.profiler import ProfileData

    scopes = {_kernel_key(k): v for k, v in hlo_scopes(hlo_text).items()}
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    planes = list(ProfileData.from_file(path).planes)
    dev = [p for p in planes if p.name.startswith("/device:")]
    events = []                   # (start, end, kernel, op key or None)
    for plane in dev or planes:
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None and not dev:
                    continue
                key = None if op == "command_buffer" else _kernel_key(
                    op or ev.name)
                events.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                               _kernel_key(ev.name), key))
    if not events:
        raise ValueError(f"no device events in {path}")
    events.sort()
    # graph events take the op of the next event outside a graph
    owner, nxt = [None] * len(events), None
    for i in range(len(events) - 1, -1, -1):
        key = events[i][3]
        if key is not None and key in scopes:
            nxt = key
        owner[i] = key if key is not None else nxt
    per_scope = collections.Counter()
    per_kernel = collections.Counter()
    count = collections.Counter()
    loops = {}                    # owner op → [scope, ns, launches]
    busy, end = 0.0, events[0][0]
    for i, (s0, s1, kernel, key) in enumerate(events):
        scope = scopes.get(owner[i], "unattributed")
        per_scope[scope] += s1 - s0
        per_kernel[kernel] += s1 - s0
        count[kernel] += 1
        if key is None:
            loop = loops.setdefault(owner[i], [scope, 0, 0])
            loop[1] += s1 - s0
            loop[2] += i == 0 or events[i - 1][3] is not None
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    window = end - events[0][0]
    return {
        "scopes": {k: v / 1e6 for k, v in sorted(per_scope.items())},
        "loops": [(sc, ns / 1e6, n) for sc, ns, n in loops.values()],
        "top_ops": [(k, ns / 1e6, count[k])
                    for k, ns in per_kernel.most_common(15)],
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }
