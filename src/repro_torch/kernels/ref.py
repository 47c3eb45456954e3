"""Plain torch versions of the hand-written kernels.

They are the ground truth the CUDA kernels are held against on the card
(``chip_smoke.py``, the card-only tests), and the path the wrappers in
``kernels/bsr_spmv.py``, ``kernels/flash_attention.py``,
``kernels/wkv6.py`` and ``kernels/rg_lru.py`` take for tensors that lie
on the CPU.  Registered
custom semirings run here on every device, and so do the attention
shapes the flash kernel does not take (S != Skv, such as a decode step;
D_v != D).

The SpMV versions take the query axis written out: ``x`` is (Q, C, B) —
or (C, B) for one query, in which case the query axis is dropped from the
results.
"""

from __future__ import annotations

from typing import Optional

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
    y = _butterfly(acc, add)
    return y[0] if single else y


def _butterfly(acc, add):
    """⊕ over the last axis by the CUDA kernels' xor butterfly (offsets
    B/2 … 1); lane 0's value."""
    b = acc.shape[-1]
    j = torch.arange(b, device=acc.device)
    off = b // 2
    while off:
        acc = add(acc, acc[..., j ^ off])
        off //= 2
    return acc[..., 0]


def bsr_spmv_compact_ref(index, x: torch.Tensor,
                         semiring: str = "plus_times") -> torch.Tensor:
    """``bsr_spmv_ref`` over a compacted index (``bsr_spmv.CompactIndex``)
    in the compacted kernel's order, bit-equal to it and to
    ``bsr_spmv_ref``.

    Row v's partial for column j ⊕-accumulates its entries with that j in
    entry order (ascending tile k), then the B partials of the row are
    folded by the butterfly.  The entries the index leaves out are
    ⊕-identity products, which change no partial on the inputs the ring
    admits (finite x under plus_times, x ≥ 0 under max_min, x > -inf
    under min_plus).  Built-in rings only.  x is (Q, C, B) or (C, B);
    returns (Q, R, B) or (R, B) for the index's R row-blocks."""
    if semiring not in _MUL:
        raise ValueError(f"the compacted route implements {sorted(_MUL)}, "
                         f"not {semiring!r}")
    if semiring != index.semiring:
        raise ValueError(f"the index leaves out {index.semiring!r}'s "
                         f"identity; the call asks for {semiring!r}")
    single = x.dim() == 2
    xq = x[None] if single else x
    mul, add = _MUL[semiring], _ADD[semiring]
    b, dev = index.b, x.device
    rp = index.row_ptr.long()
    n_rows = rp.shape[0] - 1
    e0, e1 = int(rp[0]), int(rp[-1])
    src, val = index.src[e0:e1].long(), index.val[e0:e1]
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                  rp.diff())
    key = row * b + src % b                      # the (row, j) partial
    # each entry's rank among its partial's entries, in entry order
    order = torch.sort(key, stable=True).indices
    count = torch.bincount(key, minlength=n_rows * b)
    first = count.cumsum(0) - count
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.shape[0], device=dev) - first[key[order]]
    # one pass per rank: a partial takes at most one entry per pass
    by_rank = torch.sort(rank, stable=True).indices
    xf = xq.reshape(xq.shape[0], -1)
    acc = torch.full((xq.shape[0], n_rows * b), float(sr.get(semiring).zero),
                     dtype=torch.float32, device=dev)
    pos = 0
    for n in torch.bincount(rank).tolist():
        e = by_rank[pos:pos + n]
        pos += n
        k = key[e]
        acc[:, k] = add(acc[:, k], mul(val[e], xf[:, src[e]]))
    y = _butterfly(acc.view(xq.shape[0], n_rows, b), add)
    y = y.view(xq.shape[0], n_rows // b, b)
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
    return _fused_apply(
        lambda xq: bsr_spmv_ref(block_vals, block_cols, block_nnz, xq,
                                semiring),
        x, xg, valid, act_rows, damping, tol, inv_n, semiring, apply_kind)


def bsr_spmv_fused_compact_ref(index, x, xg, valid, act_rows, damping, tol,
                               inv_n, semiring: str = "min_plus",
                               apply_kind: str = "relax"):
    """``bsr_spmv_fused_ref`` with y from ``bsr_spmv_compact_ref`` over
    the index of THESE rows (a plan's index, or its ``rows(sl)`` view)."""
    return _fused_apply(
        lambda xq: bsr_spmv_compact_ref(index, xq, semiring),
        x, xg, valid, act_rows, damping, tol, inv_n, semiring, apply_kind)


def _fused_apply(spmv, x, xg, valid, act_rows, damping, tol, inv_n,
                 semiring, apply_kind):
    """y = spmv(x) → the engine's apply rule → the frontier mask."""
    # imported here: core.engine imports kernels.ops, which imports this
    # module
    from ..core.engine import _apply
    single = x.dim() == 2
    if single:
        x, xg, act_rows = x[None], xg[None], act_rows[None]
    x_new, imp = _apply(apply_kind, sr.get(semiring), spmv(x), xg, valid,
                        damping, inv_n, tol)
    x_out = torch.where(act_rows[:, :, None], x_new, xg)
    changed = act_rows & imp.any(dim=2)
    conv = changed.any(dim=1)
    if single:
        return x_out[0], changed[0], conv[0]
    return x_out, changed, conv


# ---------------------------------------------------------------------------
# attention — exact softmax attention, the plain version of flash_attention
# ---------------------------------------------------------------------------

CHUNKED_THRESHOLD = 16384


def _mask(s: int, skv: int, offset: int, causal: bool,
          window: Optional[int], device) -> torch.Tensor:
    """(s, skv) True where query row i, at key position i + offset, may
    see key j."""
    qpos = torch.arange(offset, offset + s, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _attend(q, k, v, mask, scale):
    # rounding points of the JAX package's reference: scores in the input
    # dtype, then f32; softmax in f32; p in v's dtype for the PV product
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    logits = logits.masked_fill(~mask, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0).to(v.dtype)  # fully-masked rows
    return torch.einsum("bhst,bhtd->bhsd", p, v).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention.  q: (B, H, S, D); k, v: (B, H, Skv, D) (kv already
    repeated to H heads).  window = local attention span (None = global).
    """
    s, d, skv = q.shape[2], q.shape[3], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    # the last query aligns with the last key
    return _attend(q, k, v, _mask(s, skv, skv - s, causal, window,
                                  q.device), scale)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True, window: Optional[int] = None,
                scale: Optional[float] = None,
                q_chunk: int = 1024) -> torch.Tensor:
    """Exact attention over query chunks, so the live score tensor is
    (B, H, q_chunk, Skv) at most instead of (B, H, S, Skv).  Falls back
    to ``mha_ref`` unless q_chunk divides S and S > q_chunk, as the JAX
    package's version does.  A chunk reads only the keys some row of it
    may see (causal: none past its last row; a window: none before its
    first row's span), where the JAX package's version scores every key
    and masks them: the same softmax, at about half the work and score
    bytes under a causal mask."""
    s, d, skv = q.shape[2], q.shape[3], k.shape[2]
    if s % q_chunk or s <= q_chunk:
        return mha_ref(q, k, v, causal, window, scale)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    outs = []
    for c0 in range(0, s, q_chunk):
        # row c0 + i of the query sits at key position c0 + i + (skv - s)
        first = c0 + skv - s
        hi = min(skv, first + q_chunk) if causal else skv
        lo = max(0, first - window + 1) if window is not None else 0
        lo = min(lo, hi)
        mask = _mask(q_chunk, hi - lo, first - lo, causal, window, q.device)
        outs.append(_attend(q[:, :, c0:c0 + q_chunk], k[:, :, lo:hi],
                            v[:, :, lo:hi], mask, scale))
    return torch.cat(outs, dim=2)


def attention_ref(q, k, v, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None,
                  chunk_from: int = CHUNKED_THRESHOLD) -> torch.Tensor:
    """The plain version of the attention kernel: repeat the kv heads to
    H (GQA), then ``mha_ref``, or ``mha_chunked`` from S = ``chunk_from``
    on (16384, as the JAX package's ``ops`` does; 1 where it stands in
    for the kernel, which skips masked tiles, at any S over a chunk).
    q (B, H, S, D); k, v (B, Hkv, Skv, D)."""
    h, hkv = q.shape[1], k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    if q.shape[2] >= chunk_from:
        return mha_chunked(q, k, v, causal, window, scale)
    return mha_ref(q, k, v, causal, window, scale)


# ---------------------------------------------------------------------------
# WKV6 — the RWKV-6 recurrence, the plain version of the wkv6 kernel
# ---------------------------------------------------------------------------


def wkv6_heads_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The recurrence in the model's layout, one Python step per token.

    r, k, v, w: (B, T, H, hs), any float dtype (upcast to f32); u (H, hs);
    s0 (B, H, hs, hs), keyed [k dim, v dim].  Per step, in f32:
    a = kᵀv, y = r (S + u ⊙ a), S ← diag(w) S + a.  Returns (y (B, T, H,
    hs) in r's dtype, the final state (B, H, hs, hs) f32); ``s0`` is not
    written.

    The arithmetic is the CUDA kernel's, in its order: every product and
    sum rounded once, S + u·a kept for each step, then y's sum over the
    k dim taken in ascending order from 0.  So the kernel and this
    version agree bit for bit; the JAX package's ``wkv6_ref`` sums y in
    XLA's order (atol 1e-4 at the shapes of its tests).  The kept terms
    take T·B·H·hs² floats (2.1 GB at B 4, T 1024, H 32, hs 64)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    b, n, h, hs = r.shape
    terms = rf.new_empty((n, b, h, hs, hs))
    for t in range(n):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        torch.add(s, uf * a, out=terms[t])
        s = wf[:, t, :, :, None] * s + a
    rt = rf.transpose(0, 1)                    # (T, B, H, hs)
    y = rf.new_zeros((n, b, h, hs))
    for i in range(hs):
        y = y + rt[..., i, None] * terms[..., i, :]
    return y.transpose(0, 1).to(r.dtype), s


WKV_SUB = 16  # steps per sub-chunk of the chunked kernel


def wkv6_diag_block(r, k, w, u):
    """The diagonal (WKV_SUB, WKV_SUB) blocks of the chunked form, element
    by element in f32: A[i, j] = Σ_d r_id k_jd Π_{j<s<i} w_sd for j < i,
    A[i, i] = Σ_d r_id u_d k_id, 0 above.  r, k, w (..., WKV_SUB, hs) f32,
    u broadcastable to r[..., 0, :].  The decay e^{c_{i−1} − c_j} is the
    product of the w strictly between the two steps, taken as the kernel
    takes it: k_j carried down the sub-chunk and multiplied by w_i once
    row i has read it (out of place, so autograd runs through it)."""
    sub = r.shape[-2]
    a = r.new_zeros(r.shape[:-1] + (sub,))
    kd = k
    for i in range(sub):
        a[..., i, :i] = (r[..., i, None, :] * kd[..., :i, :]).sum(-1)
        a[..., i, i] = (r[..., i, :] * u * k[..., i, :]).sum(-1)
        kd = torch.cat([kd[..., :i, :] * w[..., i, None, :], kd[..., i:, :]],
                       -2)
    return a


def _bf16_split(x):
    """x ≈ hi + lo, both bf16 (held in f32): hi = bf16(x), lo = bf16(x −
    hi), 16 significant bits between them."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm_split(a, b):
    """a @ b as the kernel forms it from bf16 operands: a_hi b_hi + a_lo
    b_hi + a_hi b_lo, in f32 (a_lo b_lo, below 2⁻¹⁶ of the product, is
    left out)."""
    ah, al = _bf16_split(a)
    bh, bl = _bf16_split(b)
    return ah @ bh + al @ bh + ah @ bl


def wkv6_chunked_heads_ref(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           s0: torch.Tensor):
    """The chunked form of the recurrence in the chunked CUDA kernel's
    blocking: the plain version of ``csrc/wkv6_chunked.cu``.

    Arguments and result as ``wkv6_heads_ref`` (here any hs and T).  Per
    sub-chunk of WKV_SUB steps (the last one padded with r = k = v = 0,
    w = 1), with c_t = Σ_{s≤t} log w_s, every decay e^{c_a − c_b} (a ≥ b)
    is the product of the w between the two steps, each ≤ 1: nothing
    overflows, and w = 0 gives exact zeros.  For step i of the sub-chunk,
    E_i is the product of its w before i, F_i of those after i, G of all
    of them (each left to right from 1).  With S the state at the
    sub-chunk's start,

        y  = (r E) S + A V,      A = ``wkv6_diag_block`` (0 above i = j),
        S ← G ⊙_rows S + (k F)ᵀ V.

    A key j of an earlier sub-chunk reaches row i through S: its decay
    factors through every sub-chunk boundary between them, each factor
    ≤ 1.  With f32 inputs that is all.  With bf16 inputs every matrix
    product is formed from bf16 operands, as the kernel forms it on the
    tensor cores: each f32 operand split into a bf16 high part and a
    bf16 remainder (``_mm_split``; v is bf16 already), sums in f32, the
    state carried in f32, y rounded to bf16 once.  So against the
    recurrence only the order of the sums and the 2⁻¹⁶ operand residue
    differ, and against the kernel only the order inside its matrix
    products and of the sum over d."""
    b, n, h, hs = r.shape
    sub = WKV_SUB
    mm = _mm_split if r.dtype == torch.bfloat16 else torch.matmul
    pad = -n % sub
    ns = (n + pad) // sub

    def subs(x, fill):  # (B, T, H, hs) → (B, H, ns, sub, hs) f32
        x = torch.nn.functional.pad(x.float().transpose(1, 2),
                                    (0, 0, 0, pad), value=fill)
        return x.reshape(b, h, ns, sub, hs)

    rr, kk, vv = (subs(x, 0.0) for x in (r, k, v))
    ww = subs(w, 1.0)
    e = [torch.ones_like(ww[..., 0, :])]
    for t in range(sub):
        e.append(e[-1] * ww[..., t, :])
    g = e.pop()                                       # G (B, H, ns, hs)
    f = [torch.ones_like(g)]
    for t in range(sub - 1, 0, -1):
        f.append(f[-1] * ww[..., t, :])
    re = rr * torch.stack(e, -2)
    kf = (kk * torch.stack(f[::-1], -2)).transpose(-1, -2)
    a = wkv6_diag_block(rr, kk, ww, u.float()[None, :, None, :])
    ay = mm(a, vv)                                    # (B, H, ns, sub, hs)
    s = s0.float().clone()                            # (B, H, hs, hs)
    ys = []
    for p in range(ns):
        ys.append(mm(re[:, :, p], s) + ay[:, :, p])
        s = g[:, :, p, :, None] * s + mm(kf[:, :, p], vv[:, :, p])
    y = torch.cat(ys, 2)[:, :, :n].transpose(1, 2)
    return y.to(r.dtype), s


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The JAX package's layout and ``wkv6_ref``: r, k, v, w (BH, T, hs);
    u (hs,) shared by every row; s0 (BH, hs, hs).  Returns (y (BH, T, hs)
    in r's dtype, s_final (BH, hs, hs) f32)."""
    y, s = wkv6_heads_ref(r[:, :, None], k[:, :, None], v[:, :, None],
                          w[:, :, None], u[None], s0[:, None])
    return y[:, :, 0], s[:, 0]


def _sum_ascending(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last dim, one add at a time from index 0, starting at
    +0: the order of a kernel thread's running sum."""
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


WKV_BWD_BLOCK = 1 << 26  # elements of one (steps, B, H, hs, hs) block


def wkv6_heads_backward_ref(r: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, w: torch.Tensor,
                            u: torch.Tensor, s0: torch.Tensor,
                            dy: torch.Tensor, ds_last: torch.Tensor):
    """The gradient of ``wkv6_heads_ref``: the plain version of
    ``csrc/wkv6_backward.cu``.

    r, k, v, w, dy (B, T, H, hs), one float dtype (upcast to f32); u (H,
    hs); s0 and ds_last (B, H, hs, hs), keyed [k dim i, v dim j].  With
    S_t = diag(w_t) S_{t−1} + a_t, a_t = k_tᵀ v_t, y_t = r_t (S_{t−1} + u
    ⊙ a_t), and G_t = ∂L/∂S_t from G_T = ds_last, in f32:

        ∂L/∂a_t = (r_t ⊙ u)ᵀ dy_t + G_t        (dA below)
        dk_t = dA v_t,   dv_t = dAᵀ k_t,   dr_t = (S_{t−1} + u ⊙ a_t) dy_t
        dw_t = Σ_j G_t ⊙ S_{t−1},   du = Σ_{b,t} r_t ⊙ k_t (dy_t · v_t)
        G_{t−1} = diag(w_t) G_t + r_tᵀ dy_t,   ds0 = G_0.

    Returns (dr, dk, dv, dw) in r's dtype, du (H, hs) f32 and ds0 (B, H,
    hs, hs) f32; nothing is written in place.

    The arithmetic is the CUDA kernel's, in its order, every product and
    sum rounded once (the kernel is built with -fmad=false): the states
    S_{t−1} recomputed forward from s0 by the recurrence, every sum over
    j (and dv's over i) ascending from 0, du summed over t from the last
    step back, then over the batch ascending.  So the kernel and this
    version agree bit for bit.  The states and G take 2·T·B·H·hs² floats
    (4.3 GB at B 2, T 1024, H 32, hs 64); the rest runs over blocks of
    steps of at most WKV_BWD_BLOCK elements."""
    rf, kf, vf, wf, dyf = (t.float().transpose(0, 1)
                           for t in (r, k, v, w, dy))   # (T, B, H, hs)
    uf = u.float()
    n, b, h, hs = rf.shape
    s, states = s0.float(), []
    for t in range(n):                                  # S_{t−1}
        states.append(s)
        s = wf[t, ..., None] * s + kf[t, ..., None] * vf[t, :, :, None, :]
    g, grads = ds_last.float(), [None] * n
    for t in range(n - 1, -1, -1):                      # G_t
        grads[t] = g
        g = wf[t, ..., None] * g + rf[t, ..., None] * dyf[t, :, :, None, :]
    ds0 = g
    outs = {name: [] for name in ("dr", "dk", "dv", "dw", "du")}
    step = max(1, WKV_BWD_BLOCK // max(1, b * h * hs * hs))
    for t0 in range(0, n, step):
        sl = slice(t0, min(n, t0 + step))
        sp, gt = torch.stack(states[sl]), torch.stack(grads[sl])
        r_, k_, v_, w_, dy_ = (x[sl] for x in (rf, kf, vf, wf, dyf))
        term = sp + uf[:, :, None] * (k_[..., :, None] * v_[..., None, :])
        outs["dr"].append(_sum_ascending(term * dy_[..., None, :]))
        outs["dw"].append(_sum_ascending(gt * sp))
        da = (r_ * uf)[..., None] * dy_[..., None, :] + gt
        outs["dk"].append(_sum_ascending(da * v_[..., None, :]))
        outs["dv"].append(_sum_ascending(
            (da * k_[..., :, None]).transpose(-1, -2)))
        outs["du"].append(r_ * k_ * _sum_ascending(dy_ * v_)[..., None])
    grads_of = {name: torch.cat(xs) if xs else rf.new_zeros(rf.shape)
                for name, xs in outs.items()}
    du_bt = grads_of.pop("du")                          # (T, B, H, hs)
    acc = uf.new_zeros((b, h, hs))
    for t in range(n - 1, -1, -1):
        acc = acc + du_bt[t]
    du = acc[0]
    for i in range(1, b):
        du = du + acc[i]
    dr, dk, dv, dw = (grads_of[name].transpose(0, 1).to(r.dtype)
                      for name in ("dr", "dk", "dv", "dw"))
    return dr, dk, dv, dw, du, ds0


def wkv6_diag_block_backward(r, k, w, u, da):
    """The gradient of ``wkv6_diag_block`` given dA (lower triangle and
    diagonal), per channel d: (dr, dk, dw) of the block, each like r.

    With P(s, t) = Π_{s<m<t} w_m and X_{q,t} = Σ_{s<t} dA_qs k_s P(s, t)
    (X_{q,t+1} = w_t X_{q,t} + dA_qt k_t):
        dr_t = X_{t,t} + dA_tt u k_t,
        dk_t = Σ_{q>t} dA_qt r_q P(t, q) + dA_tt u r_t,
        dw_t = Σ_{q>t} r_q P(t, q) X_{q,t},
    the last the derivative of every P(s, q) with s < t < q by its factor
    w_t, as the product of the others: no division.  One pass over t, an
    inner one over q > t carrying P(t, q) upwards; the kernel's order."""
    sub = r.shape[-2]
    x = [torch.zeros_like(r[..., 0, :]) for _ in range(sub)]
    dr, dk, dw = [], [], []
    for t in range(sub):
        rt, kt = r[..., t, :], k[..., t, :]
        dtt = da[..., t, t, None] * u
        dr.append(x[t] + dtt * kt)
        pp = torch.ones_like(rt)
        h, dkd = torch.zeros_like(rt), torch.zeros_like(rt)
        for q in range(t + 1, sub):
            rp = r[..., q, :] * pp
            h = h + x[q] * rp
            dkd = dkd + da[..., q, t, None] * rp
            pp = pp * w[..., q, :]
        dk.append(dkd + dtt * r[..., t, :])
        dw.append(h)
        for q in range(t + 1, sub):
            x[q] = w[..., t, :] * x[q] + da[..., q, t, None] * kt
    return torch.stack(dr, -2), torch.stack(dk, -2), torch.stack(dw, -2)


def wkv6_chunked_heads_backward_ref(r: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, w: torch.Tensor,
                                    u: torch.Tensor, s0: torch.Tensor,
                                    dy: torch.Tensor,
                                    ds_last: torch.Tensor):
    """The gradient of ``wkv6_chunked_heads_ref`` in its blocking: the
    plain version of ``csrc/wkv6_backward_chunked.cu``.

    Arguments and results as ``wkv6_heads_backward_ref``.  Per sub-chunk
    of WKV_SUB steps (the last padded with r = k = v = dy = 0, w = 1),
    with S its start state, E, F, G and A as the forward forms them, dY
    its dy and Gend = ∂L/∂S at its end (ds_last for the last one):

        ∂L/∂S  = G ⊙_rows Gend + (r E)ᵀ dY       (carried back; ds0)
        dV     = Aᵀ dY + (k F) Gend,     dA = tril(dY Vᵀ)
        d(rE)  = dY Sᵀ,  d(kF) = V Gendᵀ,  dG = Σ_j Gend ⊙ S
        dr     = d(rE) E + the block's (``wkv6_diag_block_backward``)
        dk     = d(kF) F + the block's,   du = Σ_{b,t} dA_tt r_t ⊙ k_t
        dw_t   = E_t (R_t + F_t dG) + F_t L_t + the block's,

    R_t = Σ_{q>t} d(rE)_q r_q P(t, q) and L_t = Σ_{s<t} d(kF)_s k_s P(s,
    t) running back and forth over the sub-chunk: the derivative of each
    product of w by one factor as the product of the others, with no
    logarithm, exponential or division, so w = 0 gives exact, finite
    gradients.  The start states come from the forward's recurrence over
    sub-chunks.  With bf16 inputs every matrix product is formed as the
    kernel forms it (``_mm_split``; dy, v and k are bf16 already, and dY
    Vᵀ is exact in f32), the state and ∂L/∂S carried in f32; in f32 it
    rounds nothing.  Against the kernel only the order of the sums
    differs.  The states and ∂L/∂S take T/16·B·H·hs² floats each (67 MB
    at B 2, T 1024, H 32, hs 64)."""
    b, n, h, hs = r.shape
    sub = WKV_SUB
    mm = _mm_split if r.dtype == torch.bfloat16 else torch.matmul
    pad = -n % sub
    ns = (n + pad) // sub

    def subs(x, fill):  # (B, T, H, hs) → (B, H, ns, sub, hs) f32
        x = torch.nn.functional.pad(x.float().transpose(1, 2),
                                    (0, 0, 0, pad), value=fill)
        return x.reshape(b, h, ns, sub, hs)

    rr, kk, vv, dyy = (subs(x, 0.0) for x in (r, k, v, dy))
    ww = subs(w, 1.0)
    uf = u.float()[None, :, None, :]
    e = [torch.ones_like(ww[..., 0, :])]
    for t in range(sub):
        e.append(e[-1] * ww[..., t, :])
    g = e.pop()                                       # G (B, H, ns, hs)
    f = [torch.ones_like(g)]
    for t in range(sub - 1, 0, -1):
        f.append(f[-1] * ww[..., t, :])
    ee, ff = torch.stack(e, -2), torch.stack(f[::-1], -2)
    re, kf = rr * ee, kk * ff                         # (B, H, ns, sub, hs)
    a = wkv6_diag_block(rr, kk, ww, uf)
    s, states = s0.float(), []
    for p in range(ns):
        states.append(s)
        s = g[:, :, p, :, None] * s + mm(kf[:, :, p].transpose(-1, -2),
                                         vv[:, :, p])
    gacc, gends = ds_last.float(), [None] * ns
    for p in range(ns - 1, -1, -1):
        gends[p] = gacc
        gacc = g[:, :, p, :, None] * gacc + mm(
            re[:, :, p].transpose(-1, -2), dyy[:, :, p])
    ss, gend = torch.stack(states, 2), torch.stack(gends, 2)
    del states, gends
    d_re = mm(dyy, ss.transpose(-1, -2))
    d_kf = mm(vv, gend.transpose(-1, -2))
    da = torch.tril(dyy @ vv.transpose(-1, -2))
    dv = mm(a.transpose(-1, -2), dyy) + mm(kf, gend)
    dg = (gend * ss).sum(-1)[..., None, :]
    del ss, gend
    aa, bb = d_re * rr, d_kf * kk
    rs, ls = [torch.zeros_like(g)], [torch.zeros_like(g)]
    for t in range(sub - 1):
        rs.append(aa[..., sub - 1 - t, :] + ww[..., sub - 1 - t, :] * rs[-1])
        ls.append(bb[..., t, :] + ww[..., t, :] * ls[-1])
    rsum, lsum = torch.stack(rs[::-1], -2), torch.stack(ls, -2)
    dr_a, dk_a, dw_a = wkv6_diag_block_backward(rr, kk, ww, uf, da)
    dr = d_re * ee + dr_a
    dk = d_kf * ff + dk_a
    dw = ee * (rsum + ff * dg) + ff * lsum + dw_a
    du_bh = (torch.diagonal(da, dim1=-2, dim2=-1)[..., None]
             * rr * kk).sum((2, 3))                   # (B, H, hs)
    du = du_bh[0]
    for i in range(1, b):
        du = du + du_bh[i]

    def back(x):  # (B, H, ns, sub, hs) → (B, T, H, hs) in r's dtype
        return x.reshape(b, h, ns * sub, hs)[:, :, :n].transpose(
            1, 2).to(r.dtype)

    return back(dr), back(dk), back(dv), back(dw), du, gacc


# ---------------------------------------------------------------------------
# RG-LRU — the Griffin scan h_t = a_t·h_{t−1} + g_t, forward and backward
# ---------------------------------------------------------------------------


def rg_lru_scan_ref(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t−1} + g_t over t, the plain version of
    ``csrc/rg_lru.cu``'s forward.  a, g (B, S, ld) f32; h0 (B, ld).
    Returns (h (B, S, ld) f32, every step's, and h_last (B, ld) f32).
    Each step a product and a sum, each rounded once, as the kernel's
    (built with -fmad=false): the two agree bit for bit."""
    h, hs = h0.float(), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        hs.append(h)
    if not hs:
        return a.new_zeros(a.shape), h
    return torch.stack(hs, 1), h


def rg_lru_scan_backward_ref(a: torch.Tensor, h0: torch.Tensor,
                             h_all: torch.Tensor, dh: torch.Tensor,
                             dh_last: torch.Tensor):
    """The gradient of ``rg_lru_scan_ref``, the plain version of
    ``csrc/rg_lru.cu``'s backward: with H_t = dh_t + a_{t+1} H_{t+1} from
    H_S = dh_S + dh_last, da_t = H_t h_{t−1} (h_0 = h0), dg_t = H_t and
    dh0 = a_1 H_1.  a, h_all (the forward's h), dh (B, S, ld) f32; h0,
    dh_last (B, ld).  Returns (da, dg (B, S, ld), dh0 (B, ld)), f32, each
    product and sum rounded once in the kernel's order."""
    n = a.shape[1]
    carry, da, dg = dh_last.float(), [None] * n, [None] * n
    for t in range(n - 1, -1, -1):
        ht = dh[:, t] + carry
        da[t] = ht * (h_all[:, t - 1] if t else h0.float())
        dg[t] = ht
        carry = a[:, t] * ht
    if not n:
        return a.new_zeros(a.shape), a.new_zeros(a.shape), carry
    return torch.stack(da, 1), torch.stack(dg, 1), carry
