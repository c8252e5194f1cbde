#!/usr/bin/env python3
"""Time the row gathers the trainable-q pair forward can use, on the card.

The flat pair forward (spectral/magnetic.py ``_template_pair_forward``)
gathers one x row per edge before it builds its [E, 4F] messages.  This
times ``x[col]`` and ``x.index_select(0, col)`` at the magnet_mxu
template's layer-2 shape (E=4,912,924 edges over a 65,536-row table,
2F=64 float32; random columns, sorted, a best case for locality), in
turns (a, b, b, a), and the message build that follows.

    python3 scripts/ab_pair_gather.py
"""
import statistics
import subprocess

import torch

E, N, W = 4_912_924, 65_536, 64


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, W, device="cuda", generator=gen)
    col = torch.sort(torch.randint(0, N, (E,), device="cuda",
                                   generator=gen)).values.to(torch.int32)
    v = torch.randn(E, 4, device="cuda", generator=gen)
    idx = col.long()
    assert torch.equal(x[idx], x.index_select(0, idx))
    res = {}
    for name in ("advanced", "index_select", "index_select", "advanced"):
        fn = ((lambda: x[idx]) if name == "advanced"
              else (lambda: x.index_select(0, idx)))
        res.setdefault(name, []).append(time_ms(fn))
    g = x.index_select(0, idx)
    res["long"] = [time_ms(lambda: col.long())]
    res["messages"] = [time_ms(lambda: (g.view(-1, 1, 2, W // 2)
                                        * v.view(-1, 2, 2, 1)).reshape(
                                            -1, 2 * W))]
    print(f"{smi}: gather [{E}, {W}] f32 from {N} rows, ms (a, b, b, a "
          f"order): {res}")


if __name__ == "__main__":
    main()
