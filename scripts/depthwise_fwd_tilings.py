"""Time the depthwise forward kernel's modes under several tilings on one
CUDA card.

    PYTHONPATH=. python3 scripts/depthwise_fwd_tilings.py [TILE:FRAMES ...]   # repo root

A tiling is ``DW_FWD_TIME_TILE:DW_FWD_THREAD_FRAMES`` (frames of a block,
consecutive frames a thread sums; their ratio times 8 must be a multiple
of 32 threads).  Each is compiled into a library of its own under
``build/`` (one ``nvcc`` per source and tiling, all at once), and the
wrappers are pointed at each library in turn.  The fused modes are timed
where the main paths call them: eval (``glu_bn_act``) at the served
(1, 74, 288) and the scored (32, 74, 288) shape, the training forward
(``glu``) and dX with the GLU backward (``glu_dx``) at the train shape
(8, 99, 288), and the plain mode at the served and the train shape.  Two
passes over the tilings in opposite orders; each time is the mean of the
two, in ms, by ``chip_smoke.device_ms``.  One JSON line per tiling, after
the card's name and power limit.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as c
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw

DEFAULT = ("24:2", "16:4", "8:2", "16:2", "16:1", "8:1", "20:1", "32:1", "32:2", "32:4",
           "32:8", "64:2", "64:4", "64:8")


def flags(tile: int, frames: int) -> tuple:
    tiling = dict(_build.TILING, DW_FWD_TIME_TILE=tile, DW_FWD_THREAD_FRAMES=frames)
    return tuple(f for f in _build.NVCC_FLAGS if not f.startswith("-D")) + tuple(
        f"-D{name}={value}" for name, value in tiling.items())


def use(target) -> None:
    """Point every wrapper at the library ``target``."""
    _build.library_path = lambda flags=None: target
    _build.lib.cache_clear()
    _build.lib()


def main() -> int:
    if not torch.cuda.is_available():
        print("depthwise_fwd_tilings: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tilings = [tuple(map(int, arg.split(":"))) for arg in (sys.argv[1:] or DEFAULT)]
    targets = {t: _build.library_path(flags(*t)) for t in tilings}
    with ThreadPoolExecutor(len(tilings)) as pool:
        for t, target in targets.items():
            if not target.exists():
                pool.submit(_build.build, target, flags(*t))
    missing = [t for t, target in targets.items() if not target.exists()]
    if missing:
        # build again in the foreground, so that nvcc's message is raised
        _build.build(targets[missing[0]], flags(*missing[0]))

    gen = torch.Generator().manual_seed(0)
    serve = c.fused_inputs(*c.SERVE_DW_SHAPE, gen)
    score = c.fused_inputs(*c.SCORE_DW_SHAPE, gen)
    train = c.fused_inputs(*c.TRAIN_DW_SHAPE, gen)
    cases = {
        "glu_bn_act@serve": lambda h, m, w, b, bn, g: dw.glu_depthwise_bn_act(h, m, w, b, bn,
                                                                              "swish"),
        "glu_bn_act@b32": lambda h, m, w, b, bn, g: dw.glu_depthwise_bn_act(h, m, w, b, bn,
                                                                            "swish"),
        "glu@train": lambda h, m, w, b, bn, g: dw.glu_depthwise(h, m, w, b),
        "glu_dx@train": lambda h, m, w, b, bn, g: dw.glu_depthwise_dx(g, w, h, m),
        "plain@serve": lambda h, m, w, b, bn, g: dw.depthwise_conv1d(g, w, b),
        "plain@train": lambda h, m, w, b, bn, g: dw.depthwise_conv1d(g, w, b),
    }
    inputs = {"serve": serve, "b32": score, "train": train}
    times = {t: {name: [] for name in cases} for t in tilings}
    with torch.no_grad():
        for order in (tilings, tilings[::-1]):
            for t in order:
                use(targets[t])
                for name, fn in cases.items():
                    args = inputs[name.split("@")[1]]
                    times[t][name].append(c.device_ms(lambda: fn(*args)))
    for t in tilings:
        tile, frames = t
        print(json.dumps({
            "time_tile": tile, "thread_frames": frames, "threads": 8 * tile // frames,
            "blocks": {name: -(-ch // dw.FWD_CHANNEL_TILE) * -(-frames_in // tile) * b
                       for name, (b, frames_in, ch, _) in (("serve", c.SERVE_DW_SHAPE),
                                                   ("b32", c.SCORE_DW_SHAPE),
                                                   ("train", c.TRAIN_DW_SHAPE))},
            "ms": {name: sum(v) / len(v) for name, v in times[t].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
