"""Spectrum-corpus preparation for the forecasting task (port of
``speechlid_tpu/cli/prepare_spectrum.py``).

Analog of the reference's two raw-data utilities
(spec_pred/data/convert.py and spec_pred/gen_raw_graph.py):

``convert``
    Pack a JSONL dump — one ``{"data": [...], "date": "..."}`` object per
    line — into the dense ``(T, D)`` ``.npy`` series that
    ``main_extras spec_pred --data`` consumes, plus a sidecar
    ``<out>.dates.json``.  Values are stored int16 (reference ``np.short``)
    unless ``--dtype`` says otherwise.

``plot``
    Render threshold-denoised spectrogram segments as PNGs: bins below
    ``mean + --threshold-db`` are floored to the minimum (the reference's
    denoise loop), then each ``--interval``-row segment is drawn with
    matplotlib.  Useful for eyeballing the raw corpus before training.

Usage:
    python -m speechlid_tpu_torch.cli.prepare_spectrum convert data.jsonl data.npy
    python -m speechlid_tpu_torch.cli.prepare_spectrum plot data.npy img/ \
        --interval 100 --start 3300
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def convert(jsonl_path: str, out_npy: str, dtype: str = "int16"):
    """JSONL ``{"data": [...], "date": ...}`` lines → packed (T, D) .npy
    (+ ``<out>.dates.json``).  Returns the packed array."""
    rows, dates = [], []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            rows.append(np.asarray(item["data"]))
            dates.append(item.get("date"))
    if not rows:
        raise SystemExit(f"no records in {jsonl_path}")
    widths = {r.shape for r in rows}
    if len(widths) != 1:
        raise SystemExit(f"ragged rows: saw shapes {sorted(widths)}")
    data = np.stack(rows).astype(np.dtype(dtype))
    if not out_npy.endswith(".npy"):
        out_npy += ".npy"  # np.save appends it anyway; keep paths in sync
    np.save(out_npy, data)
    sidecar = os.path.splitext(out_npy)[0] + ".dates.json"
    with open(sidecar, "w") as f:
        json.dump(dates, f)
    print(f"{out_npy}: {data.shape} {data.dtype} "
          f"({os.path.getsize(out_npy) / 1e6:.1f} MB); dates → {sidecar}")
    return data


def denoise(seg: np.ndarray, threshold_db: float) -> np.ndarray:
    """Floor bins below ``mean + threshold_db`` to the segment minimum
    (vectorized form of the reference's per-bin loop)."""
    seg = np.asarray(seg, np.float32)
    return np.where(seg >= seg.mean() + threshold_db, seg, seg.min())


def plot(npy_path: str, out_dir: str, interval: int = 100, start: int = 0,
         threshold_db: float = 80.0, limit: int | None = None):
    """Write one PNG per ``interval``-row segment of the (T, D) series."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # matplotlib absent from a slim image
        raise SystemExit(f"plotting needs matplotlib: {e}")

    data = np.load(npy_path).astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for lo in range(start, data.shape[0], interval):
        seg = data[lo : lo + interval]
        if seg.shape[0] < interval:
            break
        d = denoise(seg.T, threshold_db)  # (D freq bins, interval steps)
        fig, ax = plt.subplots(figsize=(10, 5))
        im = ax.imshow(d, origin="lower", aspect="auto", cmap="magma",
                       extent=(lo, lo + interval, 0, d.shape[0]))
        ax.set_xlabel("time step")
        ax.set_ylabel("freq bin")
        fig.colorbar(im, ax=ax, label="level (dB)")
        path = os.path.join(out_dir, f"{lo + interval - 1}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
        if limit is not None and len(written) >= limit:
            break
    print(f"{len(written)} segment plots → {out_dir}")
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="JSONL → packed .npy series")
    c.add_argument("jsonl")
    c.add_argument("out_npy")
    c.add_argument("--dtype", default="int16")

    p = sub.add_parser("plot", help="threshold-denoised segment PNGs")
    p.add_argument("npy")
    p.add_argument("out_dir")
    p.add_argument("--interval", type=int, default=100)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--threshold-db", type=float, default=80.0)
    p.add_argument("--limit", type=int, default=None)

    args = ap.parse_args(argv)
    if args.cmd == "convert":
        convert(args.jsonl, args.out_npy, args.dtype)
    else:
        plot(args.npy, args.out_dir, args.interval, args.start,
             args.threshold_db, args.limit)


if __name__ == "__main__":
    main()
