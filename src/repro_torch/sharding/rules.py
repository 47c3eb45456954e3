"""Logical-axis sharding rules (MaxText-style) on PyTorch's DTensor.

The JAX package's ``sharding/rules.py``.  Every parameter / activation
carries a tuple of *logical* axis names; a rule table maps logical → mesh
axes.  ``spec_for`` drops mesh axes that are absent from the mesh (so
the same model code runs on one card, a (data, model) pod slice, or a
(pod, data, model) multi-pod mesh) and refuses shardings that do not
divide the dimension (that dim is replicated instead of padded).

Default layout = FSDP × TP:
  batch        → (pod, data)     activations
  embed        → data            parameter d_model dim (ZeRO-3 style)
  heads/mlp/vocab/expert → model tensor parallelism
  kv_seq       → model           decode KV cache (flash-decoding style;
                                 GQA kv_heads < |model| so we shard time)

A spec is the port's own ``PartitionSpec``: a tuple with one entry per
tensor dim, each None, a mesh axis name, or a tuple of names, equal
entry by entry to the JAX package's.  ``placements_for`` turns it into
DTensor placements on a ``DeviceMesh`` (a dim split over several mesh
axes is ``Shard(d)`` on each of them, major axis first: the rule table
lists axes in mesh order).  The mesh in force is set by ``use_mesh``;
without one ``constrain`` is the identity, as on one card.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..train import tree as T

# logical axis -> mesh axes (tried in order; tuple = shard over several)
# "embed"-class axes are GREEDY-FILL: resolved in a second pass so they
# soak up whatever mesh axes the structured dims (heads/kv/mlp/vocab)
# could not use — e.g. GQA kv_heads (1–8) never divides model=16, so
# wk/wv would otherwise replicate 16× on the model axis.
_GREEDY = ("embed", "embed2")
# "model2" entries are inert on the standard (data, model) mesh and give
# the factored mesh (data, model=8, model2=2) full coverage: heads that
# divide 8 but not 16 shard over "model", while mlp/vocab/... take both.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data", "model", "model2"),
    "embed2": ("data", "model", "model2"),
    # kv projections keep embed on data only (the reference's GSPMD
    # conflict with the attention einsums' kv_heads sharding)
    "embed_kv": ("data",),
    "heads": ("model", "model2"),
    "kv_heads": ("model", "model2"),
    "mlp": ("model", "model2"),
    "vocab": ("model", "model2"),
    "expert": ("model", "model2"),
    "kv_seq": ("model", "model2"),
    "seq": (),
    "seq_model": ("model", "model2"),  # sequence-parallel boundary
    "head_dim": (),
    "qk_dim": (),
    "state": (),
    "layers": (),
    "conv": (),
    "lora": (),
    "capacity": (),
    "enc_seq": (),
    "img_seq": (),
    "stack": (),
    "norm": (),
}

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (sharded over each, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def parse_axes(axes) -> Tuple[Optional[str], ...]:
    """Axes are spelled as a space-separated string; '.' = None.
    e.g. "embed heads head_dim"."""
    if isinstance(axes, str):
        return tuple(None if a == "." else a for a in axes.split())
    return tuple(axes)


def mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with a
    ``shape`` mapping (the reference's tests pass namespaces)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return mesh.shape


def spec_for(shape: Sequence[int], axes, mesh,
             rules: Optional[Dict] = None) -> PartitionSpec:
    """Build a PartitionSpec for ``shape`` whose dims are named ``axes``.

    Two-phase: structured dims first (heads/mlp/vocab/...), then the
    greedy-fill dims ("embed") claim any mesh axes still unused — so a
    kv_heads=8 weight still ends up 256-way sharded via its embed dim."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    axes = parse_axes(axes)
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    parts: list = [None] * len(shape)

    def assign(i, dim, name):
        picked = []
        extent = 1
        for ax in rules.get(name, ()):
            if ax in sizes and ax not in used:
                if dim % (extent * sizes[ax]) == 0:
                    picked.append(ax)
                    extent *= sizes[ax]
                    used.add(ax)
        if picked:
            parts[i] = tuple(picked) if len(picked) > 1 else picked[0]

    for i, (dim, name) in enumerate(zip(shape, axes)):
        if name is not None and name not in _GREEDY:
            assign(i, dim, name)
    for i, (dim, name) in enumerate(zip(shape, axes)):
        if name in _GREEDY:
            assign(i, dim, name)
    return PartitionSpec(*parts)


def tree_spec(params, param_axes, mesh, rules: Optional[Dict] = None):
    """Map a (params, axes-string) tree pair to a PartitionSpec tree.
    A leaf is anything with a ``shape``."""
    return T.tree_map(lambda p, a: spec_for(tuple(p.shape), a, mesh, rules),
                      params, param_axes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on the
    ``DeviceMesh`` ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(ax) for ax in group]
        assert idx == sorted(idx), (
            f"mesh axes {group} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements: Sequence, mesh, ndim: int) -> PartitionSpec:
    """The inverse of ``placements_for``: the spec of a DTensor laid out
    by ``placements`` (Partial is not a layout of a stored tensor)."""
    from torch.distributed.tensor import Replicate, Shard
    parts: list = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"{pl} on {name} is not a stored layout")
    return PartitionSpec(*(None if not p else p[0] if len(p) == 1
                           else tuple(p) for p in parts))


def param_shardings(params, param_axes, mesh,
                    rules: Optional[Dict] = None):
    """The placements tree of ``params`` (anything with a ``shape``) on
    the ``DeviceMesh`` ``mesh``."""
    return T.tree_map(lambda s: placements_for(s, mesh),
                      tree_spec(params, param_axes, mesh, rules))


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """One device's shard of a ``shape`` tensor laid out by ``spec`` (every
    sharded dim divides: ``spec_for`` shards no other)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, part in zip(shape, spec):
        group = () if part is None else \
            (part,) if isinstance(part, str) else tuple(part)
        n = math.prod(sizes[ax] for ax in group)
        assert dim % n == 0, (shape, spec)
        out.append(dim // n)
    return tuple(out)


def abstract(shape: Sequence[int], dtype, spec: Sequence, mesh):
    """A DTensor of global ``shape`` laid out by ``spec`` whose local
    shard lies on the ``meta`` device: nothing is allocated.  On a mesh
    of one device the shard is the whole tensor, and the plain meta
    tensor is returned: there is nothing to lay out."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device="meta")
    if math.prod(mesh_shape(mesh).values()) == 1:
        return local
    return DTensor.from_local(local, mesh, placements_for(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(leaf: torch.Tensor, spec: Sequence, mesh):
    """``leaf`` as a DTensor laid out by ``spec``: a meta leaf becomes an
    ``abstract`` one, any other is split by ``distribute_tensor``."""
    if leaf.device.type == "meta":
        return abstract(tuple(leaf.shape), leaf.dtype, spec, mesh)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(leaf.detach(), mesh, placements_for(spec, mesh))


@contextlib.contextmanager
def shapes_only():
    """Work tensors out on ``meta`` outside every dispatch mode: shapes a
    caller needs before it lays the shards out, which no device holds
    (a dry run's counters see only the shards)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


def distribute_parameter(module, param, spec: Sequence, mesh):
    """Put ``param`` of ``module`` (found by identity) laid out by
    ``spec`` on ``mesh`` in its place (``distribute``); returns the new
    parameter."""
    new = torch.nn.Parameter(distribute(param, spec, mesh),
                             requires_grad=param.requires_grad)
    for name, p in module.named_parameters():
        if p is param:
            owner, _, attr = name.rpartition(".")
            setattr(module.get_submodule(owner), attr, new)
            return new
    raise KeyError("the parameter is not in the module")


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# the mesh in force
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None) the one ``constrain`` and
    the flash-decoding path see inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _current_mesh():
    return _MESH.get()


def constrain(x, axes: Sequence[Optional[str]],
              rules: Optional[Dict] = None):
    """Lay ``x`` out by its logical ``axes`` on the mesh in force: a
    ``redistribute`` of a DTensor to the spec's placements.  The identity
    without a mesh (one card), and for a tensor that is not a DTensor."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(tuple(x.shape), axes, mesh, rules)
    return x.redistribute(mesh, placements_for(spec, mesh))
