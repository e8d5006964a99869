"""The readings that a cell's limits are set from, many seeds in one process
(the benchmark's own runs do not run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... [--control 3] [--faults 3]

For each seed: the program's checked steps against the reference's (the
lower reading of each number), and on the first ``--control`` seeds the
control (the reference one precision step below the configuration's: fp8
products for bf16, TF32 for f32 with TF32 off) against the reference, and
on the first ``--faults`` seeds the program with half of each batch left
out against the reference. One JSON line a reading, with the verdict
under the cell's own limits (``correct``; the control and a fault have to
come out false), also appended to ``chiprun_out/calibrate.jsonl`` when
that directory exists.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import compare, run  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402
from portbench.traffic import make_inputs  # noqa: E402


def lower_precision(traffic: dict) -> str:
    return "tf32" if traffic["mixed_precision"] == "float32" else "fp8"


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_side(cell: dict, seed: int, inputs, device, fault=None) -> dict:
    config, traffic, check = cell["config"], cell["traffic"], cell["check"]
    program = run.Program(config, traffic, device)
    run.load_program(program, config, traffic, seed, device)
    readings = run.program_readings(program, inputs, check["checked_steps"], fault)
    program.free()
    del program
    free(device)
    return readings


def calibrate(cell: dict, seeds, controls: int, faults: int, device=None, out=None):
    device = run.device_of(cell, device)
    config, traffic, check = cell["config"], cell["traffic"], cell["check"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(traffic.get("tf32", False))
    checked, rows = check["checked_steps"], check["reference_block_rows"]
    lines = []
    for k, seed in enumerate(seeds):
        t = time.perf_counter()
        inputs = make_inputs(traffic, config, run.derived_seed(seed, 2), device)
        sides = {"program": program_side(cell, seed, inputs, device)}
        if k < faults:
            sides["half_batch"] = program_side(cell, seed, inputs, device, "half_batch")
        ref = run.reference_readings(config, traffic, seed, inputs, checked, rows, device)
        free(device)
        if k < controls:
            sides["control"] = run.reference_readings(config, traffic, seed, inputs, checked, rows, device,
                                                      Numerics(lower_precision(traffic)))
            free(device)
        for kind, readings in sides.items():
            nums = compare.numbers(readings, ref)
            within, _ = compare.verdict(nums, check["limits"])
            failed = any(x != x or abs(x) == float("inf") for x in readings["losses"])
            line = {"workload": cell["name"], "seed": seed, "kind": kind, "correct": within and not failed, **nums,
                    "losses": readings["losses"], "ref_losses": ref["losses"],
                    "seconds": time.perf_counter() - t}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
        del inputs
        free(device)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--faults", type=int, default=0)
    args = parser.parse_args(argv)
    cell = run.load_cell(args.workload)
    out_dir = os.path.join(run.ROOT, "chiprun_out")
    out = os.path.join(out_dir, "calibrate.jsonl") if os.path.isdir(out_dir) else None
    try:
        calibrate(cell, [int(s) for s in args.seeds.split(",")], args.control, args.faults, out=out)
    except run.NoDevice as exc:
        print(f"calibrate: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
