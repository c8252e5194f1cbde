"""Reading a ``torch.profiler`` trace of a traced stretch of epochs:
device operations by kernel family, the device's busy time and the
stretch's span, and the longest idle gaps named by the benchmark's own
host spans (``port_bench.*`` record_function ranges)."""
import json
import os
from typing import List, Optional, Tuple

import torch

SPAN_PREFIX = "port_bench."


def load_families(root: str) -> List[dict]:
    """``kernels/*.json`` in name order: ``label``, ``match`` and
    ``exclude`` (substrings of trace kernel names), ``spmm``."""
    d = os.path.join(root, "port_bench", "kernels")
    out = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                fam = json.load(f)
            fam["file"] = name[:-5]
            out.append(fam)
    return out


def family_of(name: str, families: List[dict]) -> Optional[dict]:
    for fam in families:
        if any(m in name for m in fam["match"]) and not any(
                x in name for x in fam.get("exclude", ())):
            return fam
    return None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """``ops``: (name, start us, end us) of every device operation;
    ``spans``: (name, start us, end us) of the benchmark's host spans."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]],
                 families: List[dict]):
        self.ops, self.spans, self.families = ops, spans, families
        self.merged = _union((s, e) for _, s, e in ops)
        self.busy_s = sum(e - s for s, e in self.merged) / 1e6
        starts = [s for _, s, _ in spans] + [s for s, _ in self.merged]
        ends = [e for _, _, e in spans] + [e for _, e in self.merged]
        self.t0 = min(starts) if starts else 0.0
        self.t1 = max(ends) if ends else 0.0
        self.span_s = (self.t1 - self.t0) / 1e6

    @classmethod
    def from_profile(cls, prof, families):
        ops, spans = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    ops.append((e.name, tr.start, tr.end))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, tr.start, tr.end))
        return cls(ops, spans, families)

    def family_seconds(self, spmm: bool) -> float:
        total = 0.0
        for name, s, e in self.ops:
            fam = family_of(name, self.families)
            if fam is not None and bool(fam.get("spmm")) == spmm:
                total += e - s
        return total / 1e6

    def _label(self, name: str) -> str:
        fam = family_of(name, self.families)
        return f"[{fam['label']}] {name}" if fam else name

    def _host_at(self, t: float) -> str:
        inside = [(e - s, n) for n, s, e in self.spans if s <= t <= e]
        return min(inside)[1][len(SPAN_PREFIX):] if inside else "none"

    def breakdown(self, limit: int = 10) -> dict:
        by_name = {}
        for name, s, e in self.ops:
            label = self._label(name)[:200]
            by_name[label] = by_name.get(label, 0.0) + (e - s) / 1e6
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
        edges = [self.t0] + [x for iv in self.merged for x in iv] + [self.t1]
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append(((b - a) / 1e6,
                             f"host: {self._host_at((a + b) / 2)}"))
        longest = sorted(gaps, key=lambda g: -g[0])[:limit]
        return dict(device_ops=[[n, v] for n, v in device_ops],
                    idle_gaps=[[label, sec] for sec, label in longest])
