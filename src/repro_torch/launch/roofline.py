"""Roofline terms on the H100: one kernel invocation, and the dry run's
dumps.

The JAX package's ``launch/roofline.py``, with the constants of one
NVIDIA H100 SXM (NVIDIA's "H100 Tensor Core GPU" datasheet, dense rates
without sparsity):

  t_compute   = flops / PEAK_FLOPS       (67e12: float32 on the CUDA
                cores, since the autotuner times the f32 semiring SpMV;
                BF16_PEAK_FLOPS, the tensor cores' 989e12, for the bf16
                dry-run cells)
  t_memory    = hbm_bytes / HBM_BW       (3.35e12 B/s of HBM3)
  t_collective = ici_bytes / ICI_BW      (NVLink: 450e9 B/s each way, in
                the place of the TPU's inter-chip links)

``kernel_roofline`` models one kernel invocation; the modelled time
assumes compute and memory overlap perfectly:
``max(t_compute, t_memory) + t_collective``.  ``chip_smoke.py`` reads
its bounds' peaks from the constants here.

``load_cells``, ``roofline_row``, ``make_table`` and ``main`` read
``launch/dryrun``'s dumps (either package's: the JSON layout is the
same) through ``launch/analytic``: per (arch × shape) the per-device
compute, memory and collective seconds of one step, the dominant term,
and the model-FLOP share.  The device count comes from each dump's mesh
("16x16" is 256, "2x16x16" 512).  The bytes are the dry run's (every op's
inputs read and outputs written once), so the memory term is an upper
bound where a fused kernel keeps data on chip.

Usage: python -m repro_torch.launch.roofline --in build/dryrun \
           [--md build/roofline.md] [--json build/roofline.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List, Optional

HBM_BW = 3.35e12           # bytes/s of HBM3 on one H100 SXM
PEAK_FLOPS = 67e12         # float32 operations/s outside the tensor cores
BF16_PEAK_FLOPS = 989e12   # bf16 operations/s on the tensor cores, dense
ICI_BW = 450e9             # NVLink bytes/s each way, to the other cards


def kernel_roofline(flops: float, hbm_bytes: float,
                    ici_bytes: float = 0.0) -> Dict:
    """Single-card roofline for one kernel invocation: seconds per term,
    the dominant bottleneck, and the modelled runtime assuming perfect
    compute/memory overlap.  The kernel autotuner (kernels/autotune.py)
    checks each measured time against this model: a measurement below it
    means the timing is wrong (recorded; the measurement still decides)."""
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = ici_bytes / ICI_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "modeled_s": max(t_compute, t_memory) + t_coll}


def chips_of(cell: Dict) -> int:
    """Devices of the dump's mesh: "16x16" → 256, "2x16x16f" → 512."""
    return math.prod(int(n) for n in cell["mesh"].rstrip("f").split("x"))


def load_cells(directory: str) -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def roofline_row(cell: Dict) -> Optional[Dict]:
    """The roofline terms of one ``ok`` dump, per device, the compute
    term at the bf16 tensor-core peak; None for any other status."""
    if cell.get("status") != "ok":
        return None
    # not at import: the autotuner imports this module from the kernels
    from ..configs.base import get_config
    from . import analytic
    chips = chips_of(cell)
    comp = cell.get("composed") or {"cost": cell["full"]["cost"],
                                    "collectives":
                                        cell["full"]["collectives"]}
    cfg = get_config(cell["arch"])
    # the reference's XLA dumps count a prefill's q-chunk loop body once
    flops_dev = comp["cost"]["flops"] + (
        analytic.prefill_attention_correction(cfg, cell["shape"])
        if cell.get("package") != "repro_torch" else 0.0)
    bytes_dev = comp["cost"]["bytes"]
    coll_dev = comp["collectives"].get("total_bytes", 0.0)
    t_compute = flops_dev / BF16_PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / ICI_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    an = analytic.model_flops(cfg, cell["shape"])
    hlo_total = flops_dev * chips
    useful = an["model_flops"] / hlo_total if hlo_total else 0.0
    # attained fraction of the dominant roof if perfectly overlapped
    t_dom = terms[dominant]
    mfu_bound = an["model_flops"] / (chips * BF16_PEAK_FLOPS * t_dom) \
        if t_dom else 0.0
    return {
        "arch": cell["arch"], "shape": cell["shape"], "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": an["model_flops"], "hlo_flops_total": hlo_total,
        "useful_ratio": useful, "mfu_bound": mfu_bound,
        "peak_gib": cell["full"]["mem"]["peak_est_bytes"] / 2**30,
        "coll_bytes_dev": coll_dev,
        "collectives": {k: v for k, v in comp["collectives"].items()
                        if k not in ("total_bytes", "count")},
    }


def make_table(cells: List[Dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant "
        "| MODEL_FLOPS | useful (MF/HLO) | MFU bound | peak GiB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        r = roofline_row(c)
        if r is None:
            lines.append(
                f"| {c['arch']} | {c['shape']} | — | — | — | "
                f"{c['status']}: {c.get('reason', c.get('error', ''))[:60]}"
                f" | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r['mfu_bound']:.2f} | "
            f"{r['peak_gib']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="indir", default="build/dryrun")
    ap.add_argument("--md", default=None)
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    from .specs import SHAPES
    cells = load_cells(args.indir)
    order = {s: i for i, s in enumerate(SHAPES)}
    cells.sort(key=lambda c: (c["arch"], order.get(c["shape"], 9)))
    table = make_table(cells)
    print(table)
    if args.md:
        with open(args.md, "w") as f:
            f.write("# Roofline (H100 constants, per step)\n\n")
            f.write(table + "\n")
    if args.json_out:
        rows = [r for r in (roofline_row(c) for c in cells) if r]
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
