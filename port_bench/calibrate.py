#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell.

For each seed: the program's first three steps as the cell runs them
(sound), with TF32 allowed (``control_tf32``, the port's own path one
precision below the configuration's float32) and with bf16 messages
(``control_bf16``); and the plain reference's, sound and with each
planted fault ("half": half of the batch left out; "answer": an apply's
answer altered where it is produced).  Each is compared with the sound
reference by ``check.gaps``; a state left unchanged reads 1 on
``change`` by that measure and needs no run.  Prints one JSON line a
seed, then the largest sound reading and the smallest of the others for
each number.

Run from the root of a checkout, on the card:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3
        [--nodes N --draws E]
"""
import argparse
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import check, harness  # noqa: E402
from port_bench.drivers import common as driver_common  # noqa: E402
from port_bench.reference import common as ref_common  # noqa: E402

VARIANTS = {"sound": {}, "control_tf32": {"matmul_precision": "high"},
            "control_bf16": {"message_dtype": "bf16"}}
FAULTS = ("half", "answer")


def seed_readings(cell, seed, device, variants=VARIANTS, faults=FAULTS):
    root, config, traffic = harness.ROOT, cell.config, cell.traffic
    graph = harness.load_module(root, "gen", traffic["generator"]).generate(
        traffic, seed, device)
    inputs = harness.task_inputs(config, graph, seed)
    driver = harness.load_module(root, "drivers", config["model"])
    reference = harness.load_module(root, "reference", config["model"])
    params0 = ref_common.draw_params(reference.param_spec(config), seed,
                                     device)
    prog = driver.Program(config, graph, inputs, device)
    t0 = time.perf_counter()
    prog.prepare()
    got = {}
    for name, change in variants.items():
        driver_common.set_precision(dict(config, **change))
        prog.build({k: v.clone() for k, v in params0.items()}, 8)
        prog.first_steps()
        got[name] = harness.host_readings(prog.readings())
        gc.collect()
    driver_common.set_precision(config)
    prog.release()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    refs = harness.reference_readings(reference, config, graph, inputs,
                                      params0, device,
                                      faults=(None,) + tuple(faults))
    want = refs[0]
    gaps = {name: check.gaps(r, want) for name, r in got.items()}
    detail = {name: check.details(r, want) for name, r in got.items()}
    gaps.update({f"fault_{f}": check.gaps(r, want)
                 for f, r in zip(faults, refs[1:])})
    return dict(seed=seed, edges=int(graph["edge_index"].shape[1]),
                program_s=t1 - t0, reference_s=time.perf_counter() - t1,
                losses=want["losses"], gaps=gaps, details=detail)


def summary(lines):
    """Per number: the largest sound reading, the smallest of each other
    reading."""
    out = {}
    for name in lines[0]["gaps"]:
        pick = max if name == "sound" else min
        out[name] = {k: pick(ln["gaps"][name][k] for ln in lines)
                     for k in lines[0]["gaps"][name]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--nodes", type=int)
    ap.add_argument("--draws", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.Cell.find(harness.ROOT, args.workload)
    for key in ("nodes", "draws"):
        if getattr(args, key) is not None:
            cell.traffic[key] = getattr(args, key)
    device = torch.device(args.device)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        lines.append(seed_readings(cell, seed, device))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(lines),
                      "summary": summary(lines),
                      "limits": harness.limits_for(cell)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
