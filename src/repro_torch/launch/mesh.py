"""Production mesh builders on ``torch.distributed``'s ``DeviceMesh``.

The JAX package's ``launch/mesh.py``: the same shapes and axis names.
Functions, not module-level constants: importing this module starts no
process group.

A pod's mesh (256 or 512 ranks) has no counterpart on one card.  The
dry run (``launch/dryrun.py``) builds it in one process over a *fake*
world (``start_fake_world``: PyTorch's ``fake`` backend, whose
collectives return at once) and lays DTensors on it whose local shards
lie on the ``meta`` device, so nothing is allocated and nothing is sent:
the counterpart of the reference's 512 placeholder host devices.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def start_fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (the
    ``fake`` backend: collectives are accepted and return at once).  A
    world already started must be fake and of that size."""
    if dist.is_initialized():
        if dist.get_world_size() != size or \
                dist.get_backend() != "fake":
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) is already up; the mesh needs a "
                f"fake world of {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=size,
                            rank=0)


def stop_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def device_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake world of
    as many ranks (started if need be)."""
    from torch.distributed.device_mesh import init_device_mesh
    start_fake_world(math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 devices a pod; 2 pods = 512 with a leading 'pod' axis
    for cross-pod data parallelism.  Over a fake world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes)


def make_factored_mesh(*, multi_pod: bool = False, factors=(8, 2)):
    """The same 256 devices a pod with the model axis FACTORED (model=8 ×
    model2=2): architectures whose head counts do not divide 16
    (MiniCPM3: 40 heads, Llama-4: 40) shard heads over the 8-sub-axis
    while mlp/vocab still use all 16.  Over a fake world."""
    shape = (2, 16) + tuple(factors) if multi_pod else \
        (16,) + tuple(factors)
    axes = ("pod", "data", "model", "model2") if multi_pod else \
        ("data", "model", "model2")
    return device_mesh(shape, axes)


def make_host_mesh(device=None):
    """The devices there are, as (data, model): the cards (one card gives
    (1, 1) on ``cuda``), or one CPU when ``device="cpu"`` is asked for.
    Without a card and without ``device`` this raises, as every entry
    point of the port does.  Over a fake world of that size: the dry run
    lays meta shards on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' for a CPU mesh")
        device = "cuda"
    device_type = torch.device(device).type
    n = torch.cuda.device_count() if device_type == "cuda" else 1
    d = 1
    for cand in (16, 8, 4, 2, 1):
        if n % cand == 0 and n >= cand:
            d = cand
            break
    return device_mesh((n // d, d), ("data", "model"), device_type)
