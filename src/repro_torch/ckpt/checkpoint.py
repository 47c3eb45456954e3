"""Fault-tolerant checkpointing in the JAX package's on-disk format.

The JAX package's ``ckpt/checkpoint.py`` over trees of tensors (nested
dicts, ``train/tree.py``): a checkpoint is a directory ``step_XXXXXXXX``
holding ``params.npz`` and ``opt.npz`` (each leaf under its key path,
"blocks/b0/attn/wq", "m/embed", "count") and ``meta.json``, so a
checkpoint written by either package restores into the other.

  * **atomic**: written to ``step_XXXXXXXX.tmp``, then renamed;
  * **async**: the device→host copy is synchronous, the disk write runs
    on a background thread (``wait_for_async_saves`` joins them);
  * **restore** puts each leaf on the target device (the template leaf's,
    or ``device``) as it is read, and raises on a missing leaf or a shape
    mismatch; the template needs only shapes;
  * **retention**: keeps the newest ``keep`` checkpoints.

The ``.npz`` files are ``np.savez``'s: an uncompressed zip64 archive of
``<key>.npy`` members, each with its CRC-32.  They are written and read
here without ``np.savez``/``np.load``, which take a CRC pass and a copy
in Python-sized chunks (0.4-0.6 GB/s for 30 GB on the H100's host):
``_write_npz`` computes the members' CRCs on a thread pool and writes
each member in one call, and ``_read_npz`` reads each member into an
array of its own with one ``np.fromfile``, checks its CRC and moves it
to the device, several members at a time.  ``np.load`` reads what
``_write_npz`` writes, and ``_read_npz`` what ``np.savez`` writes.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..train import tree as T

_PENDING: List[threading.Thread] = []
_WORKERS = 4        # members whose CRC, read and copy run at once
_ZIP64 = 0xFFFFFFFF
_DOS_DATE = (0 << 9) | (1 << 5) | 1   # 1980-01-01, zipfile's default


def _npy_header(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    d = np.lib.format.header_data_from_array_1_0(arr)
    try:
        np.lib.format.write_array_header_1_0(buf, d)
    except ValueError:
        buf = io.BytesIO()
        np.lib.format.write_array_header_2_0(buf, d)
    return buf.getvalue()


def _crc(head: bytes, arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(arr.reshape(-1)).cast("B"),
                      zlib.crc32(head))


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **flat)``'s archive: stored (uncompressed) zip64
    members ``<key>.npy``, then the central directory."""
    arrays = {k: np.asarray(a, order="C") for k, a in flat.items()}
    heads = {k: _npy_header(a) for k, a in arrays.items()}
    entries = []
    with open(path, "wb") as f, ThreadPoolExecutor(_WORKERS) as ex:
        crcs = {k: ex.submit(_crc, heads[k], a) for k, a in arrays.items()}
        for k, a in arrays.items():
            name = (k + ".npy").encode()
            size = len(heads[k]) + a.nbytes
            crc = crcs[k].result()
            offset = f.tell()
            extra = struct.pack("<HHQQ", 1, 16, size, size)
            f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 0, 0,
                                _DOS_DATE, crc, _ZIP64, _ZIP64, len(name),
                                len(extra)) + name + extra + heads[k])
            f.write(memoryview(a.reshape(-1)).cast("B"))
            entries.append((name, crc, size, offset))
        start = f.tell()
        for name, crc, size, offset in entries:
            extra = struct.pack("<HHQQQ", 1, 24, size, size, offset)
            f.write(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45,
                                0, 0, 0, _DOS_DATE, crc, _ZIP64, _ZIP64,
                                len(name), len(extra), 0, 0, 0,
                                0o600 << 16, _ZIP64) + name + extra)
        end = f.tell()
        n = len(entries)
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0,
                            n, n, end - start, start))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, end, 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF),
                            min(n, 0xFFFF), min(end - start, _ZIP64),
                            _ZIP64, 0))


class _Npz:
    """The members of an ``np.savez`` archive, each read on demand into
    an array of its own and checked against its CRC-32."""

    def __init__(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.infos = {i.filename[:-4]: i for i in zf.infolist()
                          if i.filename.endswith(".npy")}

    def __contains__(self, key: str) -> bool:
        return key in self.infos

    def shape(self, key: str):
        return tuple(self._header(key)[0])

    def _header(self, key: str):
        info = self.infos[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self.path}: {key} is compressed")
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            fixed = f.read(30)
            n, m = struct.unpack("<HH", fixed[26:30])
            start = info.header_offset + 30 + n + m
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read = np.lib.format.read_array_header_1_0 if version == (1, 0) \
                else np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read(f)
            head_end = f.tell()
            f.seek(start)
            head = f.read(head_end - start)
        if dtype.hasobject:
            raise ValueError(f"{self.path}: {key} holds Python objects")
        return shape, fortran, dtype, head, head_end

    def __getitem__(self, key: str) -> np.ndarray:
        shape, fortran, dtype, head, offset = self._header(key)
        count = int(np.prod(shape, dtype=np.int64))
        with open(self.path, "rb") as f:
            f.seek(offset)
            flat = np.fromfile(f, dtype=dtype, count=count)
        if flat.size != count or _crc(head, flat) != self.infos[key].CRC:
            raise ValueError(f"{self.path}: {key} is truncated or fails "
                             "its CRC")
        if fortran:
            return flat.reshape(shape[::-1]).T
        return flat.reshape(shape)


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint the f32 "
                            "masters, not the working copy")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in T.items(tree)}


def _unflatten(template, z: _Npz, device) -> Dict:
    """The template's tree of the archive's leaves, each checked against
    the template's shape and put on ``device`` (default: the template
    leaf's), several at a time."""
    wanted = []
    for path, leaf in T.items(template):
        key = _key(path)
        if key not in z:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(z.shape(key)) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{z.shape(key)} vs template "
                             f"{tuple(leaf.shape)}")
        where = device if device is not None else getattr(
            leaf, "device", "cpu")
        wanted.append((path, key, where))

    def load(item):
        path, key, where = item
        return path, torch.from_numpy(z[key]).to(where)

    out: Dict = {}
    with ThreadPoolExecutor(_WORKERS) as ex:
        for path, t in ex.map(load, wanted):
            T.put(out, path, t)
    return out


def save(directory: str, step: int, params, opt_state=None,
         meta: Optional[Dict[str, Any]] = None, keep: int = 3,
         async_save: bool = False) -> str:
    """Write the checkpoint of ``step``.  Returns its final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    # synchronous device→host transfer, then the disk write
    payload = {"params": _flatten(params)}
    if opt_state is not None:
        payload["opt"] = _flatten(opt_state)
    meta = dict(meta or {}, step=step)

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, flat in payload.items():
            _write_npz(os.path.join(tmp, name + ".npz"), flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        write()
    return final


def wait_for_async_saves():
    while _PENDING:
        _PENDING.pop().join()


def _gc(directory: str, keep: int):
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, params_template, opt_template=None,
            step: Optional[int] = None, device=None):
    """(params, opt_state or None, meta) of the checkpoint at ``step``
    (default: the latest), each leaf a tensor of the file's dtype on
    ``device`` (default: its template leaf's device)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    params = _unflatten(params_template,
                        _Npz(os.path.join(path, "params.npz")), device)
    opt_state = None
    if opt_template is not None:
        opt_state = _unflatten(opt_template,
                               _Npz(os.path.join(path, "opt.npz")), device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta
