"""Plain torch versions of the hand-written kernels.

They are the ground truth the CUDA kernels are held against on the card
(``chip_smoke.py``, the card-only tests), and the path the wrappers in
``kernels/bsr_spmv.py`` take for tensors that lie on the CPU.  Registered
custom semirings run here on every device.

Both take the query axis written out: ``x`` is (Q, C, B) — or (C, B) for
one query, in which case the query axis is dropped from the results.
"""

from __future__ import annotations

import torch

from ..core import semiring as sr


# ⊗ and ⊕ of the built-in rings, one torch op each (so each rounds once,
# as the CUDA kernel's __fmul_rn/__fadd_rn do)
_MUL = {
    "plus_times": lambda w, x: w * x,
    "min_plus": lambda w, x: w + x,
    "max_min": torch.minimum,
    "min_select": lambda w, x: torch.where(torch.isfinite(w), x, torch.inf),
}
_ADD = {"plus_times": lambda a, b: a + b, "min_plus": torch.minimum,
        "max_min": torch.maximum, "min_select": torch.minimum}


def bsr_spmv_ref(block_vals: torch.Tensor, block_cols: torch.Tensor,
                 block_nnz: torch.Tensor, x: torch.Tensor,
                 semiring: str = "plus_times") -> torch.Tensor:
    """y[q, r, i] = ⊕_{k < nnz[r], j} vals[r,k,i,j] ⊗ x[q, cols[r,k], j].

    For the four built-in rings the arithmetic is the CUDA kernel's, in
    the kernel's order: lane (i, j) ⊕-accumulates its products over the
    true tiles k = 0, 1, ... < nnz[r], then the B lanes of a row are
    ⊕-combined by the same xor butterfly as the kernel's warp shuffles.
    So the kernel and this version agree bit for bit; the JAX package's
    reference groups plus_times sums otherwise (rtol 2e-6).

    Args:
      block_vals: (R, K, B, B) tile values (padded with the ⊕-identity).
      block_cols: (R, K) int32 col-block ids.
      block_nnz:  (R,) int32 true tile count per row-block; tiles at
        k ≥ nnz[r] are never combined, whatever they hold.
      x: (Q, C, B) or (C, B) input values in block layout.
      semiring: any registered semiring name; a custom ring uses its own
        mul + ⊕-reduce over identity-masked tiles.
    Returns:
      y: (Q, R, B), or (R, B) for a 2-D ``x``.
    """
    single = x.dim() == 2
    xq = x[None] if single else x
    ring = sr.get(semiring)
    r, k_max, b, _ = block_vals.shape
    lane = torch.arange(k_max, device=block_cols.device)
    live = lane[None, :] < block_nnz[:, None]              # (R, K)
    cols = block_cols.long()
    if semiring not in _MUL:
        vals = torch.where(live[:, :, None, None], block_vals,
                           float(ring.zero))
        xt = xq[:, cols][:, :, :, None, :]                 # (Q, R, K, 1, B)
        y = ring.reduce(ring.mul(vals, xt), axis=(2, 4))
        return y[0] if single else y
    mul, add = _MUL[semiring], _ADD[semiring]
    acc = torch.full((xq.shape[0], r, b, b), float(ring.zero),
                     dtype=torch.float32, device=x.device)
    for k in range(k_max):
        part = mul(block_vals[None, :, k], xq[:, cols[:, k], None, :])
        acc = torch.where(live[None, :, k, None, None], add(acc, part), acc)
    j = torch.arange(b, device=x.device)
    off = b // 2
    while off:
        acc = add(acc, acc[..., j ^ off])
        off //= 2
    y = acc[..., 0]
    return y[0] if single else y


def bsr_spmv_fused_ref(block_vals, block_cols, block_nnz, x, xg, valid,
                       act_rows, damping, tol, inv_n,
                       semiring: str = "min_plus",
                       apply_kind: str = "relax"):
    """One frontier-masked sweep: SpMV → the engine's apply rule → mask.

    Args:
      x: (Q, C, B) full source values (read-only).
      xg: (Q, R, B) current values of THESE rows.
      valid: (R, B) bool — real (non-padding) vertices.
      act_rows: (Q, R) bool — rows to relax; the others pass through.
      damping/tol/inv_n: apply-rule scalars (0-d float32 tensors).
    Returns:
      x_new (Q, R, B), changed (Q, R) bool, conv (Q,) bool — conv[q] is
      changed[q].any().  With a 2-D ``x`` the query axis is dropped.
    """
    # imported here: core.engine imports kernels.ops, which imports this
    # module
    from ..core.engine import _apply
    single = x.dim() == 2
    if single:
        x, xg, act_rows = x[None], xg[None], act_rows[None]
    y = bsr_spmv_ref(block_vals, block_cols, block_nnz, x, semiring)
    x_new, imp = _apply(apply_kind, sr.get(semiring), y, xg, valid,
                        damping, inv_n, tol)
    x_out = torch.where(act_rows[:, :, None], x_new, xg)
    changed = act_rows & imp.any(dim=2)
    conv = changed.any(dim=1)
    if single:
        return x_out[0], changed[0], conv[0]
    return x_out, changed, conv
