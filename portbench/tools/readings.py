"""The readings a cell's limit is set from and held against: sound runs, the
control and the faults.

    python3 portbench/tools/readings.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
    python3 portbench/tools/readings.py --workload <cell> --seconds <s> --seeds <n> ... --faults

Without --faults, in one process, for each seed: the cell's window at its
own size and load (the program's scene loaded once), the reference over
what it recorded, and the numbers compared (check.py) for
- the program: a sound run's reading (the lower end of the limit);
- the control: the reference itself computed in bfloat16, the precision
  below the configuration's float32, put in the program's place (the upper
  end), and whether check.judge finds it correct under the cell's limits.
With --faults, for each fault of faults.py and each seed: a whole run of
the cell (harness.execute, its own window, reference and check.judge) with
the fault planted underneath the timed path, and its `correct` and numbers.
Prints one JSON line per reading, and a summary last. Runs on the card;
with --device cpu at the sizes the tests give it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def readings(cell, seeds, seconds: float, device, log=sys.stderr):
    """[{seed, frames, program, control, control_correct, reference_s, work}]
    for each seed."""
    import numpy as np
    import torch

    from portbench import assets, cells, check
    from portbench.reference import render as ref_render
    from portbench.session import Session

    cfg, mix = cell.config, cell.mix
    loop = cells.load_module("renderers", cfg["renderer"])
    scene, _ = assets.load(cfg, device)
    gen = assets.generate(cfg)
    out = []
    for seed in seeds:
        session = Session(seed, mix, cfg["width"], cfg["height"])
        user = loop.User(scene, cfg, mix, session, device, count_rays=False)
        user.warm()
        frames = user.window(seconds, False)
        user.close()
        program = np.stack([f["out"] for f in frames])
        t0 = time.perf_counter()
        work = ref_render.new_counter()
        reference = loop.reference(gen, cfg, mix, session, frames, device, counter=work)
        t1 = time.perf_counter()
        control = loop.reference(gen, cfg, mix, session, frames, device, dtype=torch.bfloat16)
        control_values = check.numbers(control, reference)
        row = dict(seed=seed, frames=len(frames),
                   program=check.numbers(program, reference), control=control_values,
                   control_correct=check.judge(control_values, cell.limits)[0],
                   reference_s=t1 - t0, work=work)
        if log is not None:
            print(json.dumps(row), file=log, flush=True)
        out.append(row)
    return out


def fault_readings(cell, seeds, seconds: float, device, faults=None, log=sys.stderr):
    """[{fault, seed, correct, attempted, check}] for each fault and seed:
    whole runs of the cell with the fault planted."""
    from portbench import faults as planted
    from portbench import harness

    out = []
    for fault in faults or planted.FAULTS:
        for seed in seeds:
            with planted.planted(cell.config["renderer"], fault):
                line = harness.execute(cell, seed, seconds, False, device, time.perf_counter())
            row = dict(fault=fault, seed=seed, correct=line["correct"],
                       attempted=line["attempted"], check=line["check"])
            if log is not None:
                print(json.dumps(row), file=log, flush=True)
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells

    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    cell = cells.find(args.workload)
    if args.faults:
        rows = fault_readings(cell, args.seeds, args.seconds, device, log=sys.stdout)
        summary = {}
        for r in rows:
            s = summary.setdefault(r["fault"], {"correct": [], "rmse_u8": []})
            s["correct"].append(r["correct"])
            s["rmse_u8"].append(r["check"]["rmse_u8"]["value"])
        print(json.dumps({"workload": args.workload, "faults": {
            f: {"any_correct": any(s["correct"]), "rmse_u8_min": min(s["rmse_u8"])}
            for f, s in summary.items()}}), flush=True)
        return 0
    rows = readings(cell, args.seeds, args.seconds, device, log=sys.stdout)
    prog = [r["program"]["rmse_u8"] for r in rows]
    ctrl = [r["control"]["rmse_u8"] for r in rows]
    print(json.dumps({"workload": args.workload, "program_max": max(prog),
                      "control_min": min(ctrl),
                      "control_any_correct": any(r["control_correct"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
