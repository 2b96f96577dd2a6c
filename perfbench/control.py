"""Run the control of a cell on several seeds, in one process: each run is
a run of the cell whose judged iteration's outputs are the reference's
computed in bfloat16 (`check.Reference.control_outputs`).  Prints one
JSON line per seed with the numbers compared and their limits; the
control has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(spec, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
