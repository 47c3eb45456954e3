"""Int8 gradient/delta compression with error feedback: the JAX
package's ``train/compress.py`` over trees of tensors.

Used on the local-SGD outer loop's synchronisation: 4× fewer bytes per
sync than f32.  The residual of each round is added back before the next
quantisation, so the quantisation noise does not accumulate (Seide et
al. / EF-SGD).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import tree as T


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree, error):
    """Quantize a tree with error feedback.  Returns (q_tree, scales,
    new_error); ``error`` is the previous round's residual tree (zeros
    at first)."""
    q, s, err = {}, {}, {}
    for path, x in T.items(tree):
        corrected = x.float() + T.get(error, path)
        qx, sx = quantize(corrected)
        T.put(q, path, qx)
        T.put(s, path, sx)
        T.put(err, path, corrected - dequantize(qx, sx))
    return q, s, err


def decompress_tree(q, s):
    return T.tree_map(dequantize, q, s)


def zeros_error(tree):
    return T.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), tree)


def compressed_bytes(tree) -> int:
    leaves = T.leaves(tree)
    return sum(x.numel() for x in leaves) + 8 * len(leaves)
