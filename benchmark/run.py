"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
Prints one JSON line (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``checks``) as the last
line of standard output, and each number compared beside its limit as the
last lines of standard error.  Exits non-zero, printing no result, without
a card, when the port is absent, or when JAX or the JAX package has been
loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the program's build and kernel caches stay in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    sys.path[:0] = [str(HERE), str(CHECKOUT)]

    import torch

    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = runner.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
