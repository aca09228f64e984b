"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload ws4m-k32.partition --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout.  Set-up makes the cell's graph on the card
from ``--seed`` and opens the program's session, the window measures
for ``--seconds`` (to the end of the first call that finishes after
it), ``--trace 1`` adds the traced calls, and the plain reference then
checks a sample of the window's answers.  The last line of standard
output is the result object; the numbers compared, each with its limit,
are the last lines of standard error.  Exits non-zero with no result
without a CUDA card, with fewer cards than the cell asks for, without
the program beside the benchmark, or if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def result_line(result: dict, checks: dict, kind: str, chips: int) -> dict:
    """The printed object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``breakdown`` when traced), and the
    numbers compared with their limits last."""
    line = dict(result)
    line["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                      **result["device"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch writes lives in the checkout
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    import torch
    from portbench.harness import cell, spec
    print(f"imports done at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)

    bench = spec.bench()
    chips = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  -- no program, no run

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    print(f"card ready at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result, checks = cell.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), device, T_START,
                                   bench=bench)
    found = banned_modules()
    if found:
        print("loaded modules of JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 3
    line = result_line(result, checks, torch.cuda.get_device_name(device),
                       chips)
    print(f"card: {card_line()}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
