"""Single-card roofline of one kernel invocation on the H100.

The JAX package's ``launch/roofline.py`` has two halves.  The first,
``kernel_roofline``, is here with the same signature and the same
returned keys, and with the constants of one NVIDIA H100 SXM (NVIDIA's
"H100 Tensor Core GPU" datasheet, dense rates without sparsity):

  t_compute   = flops / PEAK_FLOPS       (67e12: float32 on the CUDA
                cores, since the one caller, the autotuner, times the f32
                semiring SpMV; BF16_PEAK_FLOPS is the tensor cores' rate)
  t_memory    = hbm_bytes / HBM_BW       (3.35e12 B/s of HBM3)
  t_collective = ici_bytes / ICI_BW      (NVLink: 450e9 B/s each way)

The modelled time assumes compute and memory overlap perfectly:
``max(t_compute, t_memory) + t_collective``.

The second half (``load_cells``, ``roofline_row``, ``make_table``,
``main``) reads ``launch/dryrun``'s dumps through ``launch/analytic`` and
``launch/specs``; it waits for those modules, which are not ported (they
lower the LM stack for TPU pods).  ``chip_smoke.py`` reads its bounds'
peaks from the constants here.
"""

from __future__ import annotations

from typing import Dict

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
