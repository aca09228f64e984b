"""Chip phase (l1)'s cluster jobs on two source trees, in turns.

Builds the full graph of ``chip_smoke.py`` (``watts_strogatz(n, 16, 0.3,
seed=0)``) once, writes its edge shards for two hosts, then runs on each
tree in the order A, B, B, A two ``ProcessClusterSupervisor`` jobs of two
workers over those shards: (l1)'s faulty job (worker 1 exits at superstep
6, one worker resumes from the snapshot of superstep 4) and a clean one,
8 supersteps each.  Each job runs in a child process whose ``PYTHONPATH``
is that tree's ``src``, so its supervisor and workers are that tree's
code.  Prints and writes (``--out``) every worker's mean superstep split
(the workers' own ``stats_g<gen>_p<pid>.json``) and each job's wall
seconds.  Compare two versions only within one call, on one card.

    python tools/cluster_compare.py --trees <parent root> <change root>
    python tools/cluster_compare.py --trees A B --n 20000 --device cpu
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CHILD = r'''
import json, os, sys, time
from repro_torch.kernels import _build
from repro_torch.cluster import ProcessClusterConfig, ProcessClusterSupervisor
job, wd, world = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3])
if job["device"].startswith("cuda"):
    _build.build()
t0 = time.perf_counter()
out = ProcessClusterSupervisor(ProcessClusterConfig(
    workdir=wd, num_processes=world), job).run()
wall = time.perf_counter() - t0
stats = {f: json.load(open(os.path.join(wd, f)))["split_ms"]
         for f in sorted(os.listdir(wd)) if f.startswith("stats_g")}
print("RESULT " + json.dumps({"wall_s": wall, "restarts": out["restarts"],
      "gens": [(g["gen"], g["world"], g["dead"], g["seconds"])
               for g in out["generations"]], "stats": stats}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar="ROOT",
                    help="two source trees (each holds src/repro_torch)")
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None, help="a JSON file of results")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    sys.path.insert(0, os.path.join(trees[1], "src"))
    from repro_torch.cluster import write_edge_shards
    from repro_torch.core import generators

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        g = generators.watts_strogatz(args.n, 16, 0.3, seed=0)
        shards = os.path.join(work, "shards")
        write_edge_shards(g, shards, num_hosts=2)
        del g
        print(f"graph + shards {time.perf_counter() - t0:.1f}s", flush=True)
        job = {"shard_dir": shards, "k": 32, "seed": 0, "max_iters": 8,
               "snapshot_every": 4, "device": args.device,
               "rpc_timeout": 300}
        jobs = {"faulty": {**job, "fault": {"gen": 0, "pid": 1,
                                            "iteration": 6}},
                "clean": job}
        results = []
        for turn, tree in enumerate([trees[0], trees[1], trees[1],
                                     trees[0]]):
            for name, j in jobs.items():
                wd = os.path.join(work, f"{turn}_{name}")
                env = dict(os.environ,
                           PYTHONPATH=os.path.join(tree, "src"))
                p = subprocess.run(
                    [sys.executable, "-c", CHILD, json.dumps(j), wd, "2"],
                    env=env, capture_output=True, text=True, cwd=tree)
                line = [s for s in p.stdout.splitlines()
                        if s.startswith("RESULT ")]
                if p.returncode or not line:
                    print(tree, name, "rc", p.returncode, p.stderr[-3000:])
                    return 1
                r = json.loads(line[0][len("RESULT "):])
                r.update(turn=turn, tree=tree, job=name)
                results.append(r)
                print(turn, tree, name, f"wall {r['wall_s']:.3f}s",
                      "superstep ms", {w: round(sum(s.values()), 3)
                                       for w, s in r["stats"].items()},
                      "exchange ms", {w: round(s["exchange"], 3)
                                      for w, s in r["stats"].items()},
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
