"""The control of the comparison: the plain reference in the program's place.

    python3 portbench/control.py --workload ws4m-k32.partition \
        --seconds 15 --seeds 11 12 13

runs the cell's set-up, window and check once per seed in one process,
with ``ControlSystem`` -- the reference computed in bfloat16, the
precision below the float32 the configuration states -- answering every
call.  Each seed's numbers compared are printed beside their limits; the
comparison is sound only if every seed comes out not correct.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch
    from portbench.harness import cell
    from portbench.harness.systems import ControlSystem

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    wrong = 0
    for seed in args.seeds:
        result, checks = cell.run_cell(
            args.workload, seed, args.seconds, False, device,
            time.perf_counter(), system_cls=ControlSystem)
        wrong += not result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks}), flush=True)
    print(f"control: {wrong} of {len(args.seeds)} seeds not correct",
          flush=True)
    return 0 if wrong == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
