"""Reduce a ``jax.profiler`` trace to device times.

``capture`` records a few calls of a function; ``device_events`` reads
back every kernel the GPU ran; ``summarize`` gives the window, the busy
time (union of kernel intervals), and the time per named scope — the
``jax.named_scope`` stages of ``stam.step3d`` (forcing, diffuse,
project_first, advect_vel, project_final, advect_scalars) and of
``step.sph_step`` (sort, pair_pass, update).  Device events carry the
kernel's name, not the JAX scope, so ``scope_map`` reads the scopes
from the compiled module's HLO text (each instruction's ``op_name``
metadata); an event whose name it does not know, and whose own name and
stats name no scope, counts as "other".
"""

from __future__ import annotations

import glob
import os
import re

GRID_SCOPES = ("forcing", "diffuse", "project_first", "advect_vel",
               "project_final", "advect_scalars")
SPH_SCOPES = ("sort", "pair_pass", "update")


_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=')
_COMP = re.compile(r'^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$')
_CALLS = re.compile(r'calls=%?([\w.\-]+)')
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_KERNEL_NAME = re.compile(r'\\?"name\\?"\s*:\s*\\?"([\w.\-]+)\\?"')


def scope_map(hlo_text: str, scopes) -> dict:
    """{kernel or instruction name: scope} from compiled HLO text
    (``jax.jit(f).lower(...).compile().as_text()``).  A fusion whose own
    metadata names no scope takes the scope most of the operations in
    its fused computation carry."""
    def scope_of(op_name):
        parts = op_name.split("/")
        return next((s for s in scopes if s in parts), None)

    votes, comp = {}, None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            votes.setdefault(comp, {})
            continue
        op = _OP_NAME.search(line)
        sc = scope_of(op.group(1)) if op else None
        if comp is not None and sc is not None:
            votes[comp][sc] = votes[comp].get(sc, 0) + 1
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        op, calls = _OP_NAME.search(line), _CALLS.search(line)
        scope = scope_of(op.group(1)) if op else None
        if scope is None and calls and votes.get(calls.group(1)):
            v = votes[calls.group(1)]
            scope = max(v, key=v.get)
        if scope is None:
            continue
        keys = [m.group(1)] + _KERNEL_NAME.findall(line)
        if op and "/pallas_call" in op.group(1):
            # a Pallas kernel runs under its own name: the path
            # component before "pallas_call"
            keys.append(op.group(1).split("/pallas_call")[0]
                        .rsplit("/", 1)[-1])
        for k in keys:
            out.setdefault(_kernel_key(k), scope)
    return out


def _kernel_key(name: str) -> str:
    """Kernel names in a trace spell the HLO's '.' and '-' as '_'."""
    return name.replace(".", "_").replace("-", "_")


def capture(fn, logdir: str, calls: int = 1) -> str:
    """Trace ``calls`` calls of ``fn()`` (each waited for) into
    ``logdir``; returns the .xplane.pb path."""
    import jax

    with jax.profiler.trace(logdir):
        for _ in range(calls):
            jax.block_until_ready(fn())
    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    return paths[-1]


def device_events(path: str) -> list[dict]:
    """Every event on a GPU plane: name, start/duration (ns) and the
    text of its stats."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                text = " ".join(str(v) for _, v in ev.stats)
                out.append(dict(name=ev.name, start=ev.start_ns,
                                dur=ev.duration_ns, text=text,
                                line=line.name))
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    spans = sorted((e["start"], e["start"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events, scopes, names=None) -> dict:
    """{"window_ms", "busy_ms", "idle_share", "scopes_ms": {scope: ms},
    "top": [(kernel, ms, scope), ...]} over kernel events (ones that
    carry a positive duration on a stream line).  ``names``:
    scope_map()."""
    names = names or {}
    kernels = [e for e in events if e["dur"] > 0
               and "stream" in e["line"].lower()]
    if not kernels:
        kernels = [e for e in events if e["dur"] > 0]
    if not kernels:
        return {"window_ms": 0.0, "busy_ms": 0.0, "idle_share": None,
                "scopes_ms": {}, "top": []}
    t0 = min(e["start"] for e in kernels)
    t1 = max(e["start"] + e["dur"] for e in kernels)
    per_scope = {s: 0.0 for s in scopes}
    per_scope["other"] = 0.0
    per_kernel = {}
    for e in kernels:
        hay = e["name"] + " " + e["text"]
        scope = names.get(_kernel_key(e["name"])) or next(
            (s for s in scopes if s in hay), "other")
        per_scope[scope] += e["dur"]
        key = (e["name"], scope)
        per_kernel[key] = per_kernel.get(key, 0.0) + e["dur"]
    busy = busy_ns(kernels)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms": (t1 - t0) / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(t1 - t0, 1),
            "scopes_ms": {k: v / 1e6 for k, v in per_scope.items()},
            "top": [(k, v / 1e6, sc) for (k, sc), v in top]}
