#!/usr/bin/env python3
"""The dry run's records as a Markdown table, one row an architecture and,
in each column, its four shapes (train_4k, prefill_32k, decode_32k,
long_500k; "—" a skipped cell): the bytes a slot holds of the inputs on the
single-pod mesh (and the multi-pod where it differs), the home device's
temp peak, the matmul flops and the gathered and scattered bytes. Counts
from the meta device, not times. The lines below the table name the
skipped cells, any error, and the largest per-slot arguments against one
80 GB card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    python3 tools/dryrun_table.py [artifacts/dryrun]
"""
import collections
import glob
import json
import os
import sys

CARD_BYTES = 80e9  # one H100's device memory
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def main(argv) -> int:
    out_dir = argv[1] if len(argv) > 1 else "artifacts/dryrun"
    cells = collections.defaultdict(dict)
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        cells[rec["arch"]][(rec["shape"], rec["mesh"])] = rec
    print("| arch | args GiB a slot, single (multi) | temp GiB | flops_home | transfer GB |")
    print("|---|---|---|---|---|")
    skipped, errors, largest = [], [], (0, "")
    for arch, recs in cells.items():
        cols = [[], [], [], []]
        for shape in SHAPES:
            one, multi = recs.get((shape, "single")), recs.get((shape, "multi"))
            if one is None or one["status"] != "ok":
                if one is not None and one["status"] == "error":
                    errors.append(f"{arch} x {shape}")
                elif one is not None:
                    skipped.append(f"{arch} x {shape}")
                for c in cols:
                    c.append("—")
                continue
            a1, m = one["memory"]["argument_bytes"], one["memory"]
            a2 = multi["memory"]["argument_bytes"] if multi and multi["status"] == "ok" else a1
            largest = max(largest, (max(a1, a2), f"{arch} x {shape}"))
            g1, g2 = f"{a1 / 2**30:.2f}", f"{a2 / 2**30:.2f}"
            cols[0].append(g1 + (f" ({g2})" if g2 != g1 else ""))
            cols[1].append(f"{m['temp_bytes'] / 2**30:.1f}")
            cols[2].append(f"{one['flops_home']:.2e}")
            cols[3].append(f"{one['transfer_bytes'] / 1e9:.1f}")
        print(f"| {arch} | " + " | ".join(" · ".join(c) for c in cols) + " |")
    print(f"\nskipped: {', '.join(skipped) or 'none'}; errors: {', '.join(errors) or 'none'}")
    print(f"largest per-slot arguments: {largest[1]}, {largest[0] / 2**30:.2f} GiB "
          f"({'fits' if largest[0] <= CARD_BYTES else 'does not fit'} one 80 GB card)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
