"""Readings that the limits of ``correct`` are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 8]

For each seed: the cell's set-up and a window of ``--seconds`` (training:
long enough to reach the step it keeps, after the loader's first cycle),
then the program's numbers against the reference (training: also the
leaves behind the widest gaps of the set-up's steps, with their norms).
For each control seed also the control, the reference in TF32 put in the
program's place, on the same sample or steps, and for training the
planted fault of a loss over half of each batch.  One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]

    import torch

    from harness import runner, spec

    if not torch.cuda.is_available():
        print("calibrate.py measures on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        state = runner.mode_class(cell)(cell, seed, "cuda")
        line = {"seed": seed, "setup_s": time.perf_counter() - t0}
        window = state.loop(args.seconds)
        line["end_to_end"] = state.end_to_end(window)
        state.free()
        torch.cuda.empty_cache()
        line["program"] = state.check()
        if state.train:
            line["look"] = state.look()
        if seed in controls:
            line["control"] = state.control()
            if state.train:
                line["half_batch"] = state.half_batch()
        print(json.dumps(line), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
