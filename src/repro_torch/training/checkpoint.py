"""Checkpoints in the reference's on-disk format (port of
``repro/training/checkpoint.py``): a directory holding ``arrays.npz``, one
array a leaf keyed by its path (``blocks/p0/mixer/wq``; an
:class:`~repro_torch.training.optimizer.AdamWState`'s leaves under
``mu/…``, ``nu/…`` and ``count``; a tuple's under its index), and
``meta.msgpack``, a map of ``step`` and ``keys`` (each key's shape and
dtype name). Either package restores the other's checkpoints bit for bit.

The card's machine has no ``msgpack`` package, so this module writes and
reads the subset the meta uses (maps, arrays, strings and integers)
itself, byte for byte as ``msgpack.packb`` writes it.

On a training mesh (``placement``, a ``launch.sharding.TrainPlacement``)
the tree holds this rank's blocks: saving gathers every leaf whole and only
rank 0 writes; restoring reads the whole file on every rank and keeps
the rank's blocks.

A bf16 leaf is stored as the reference stores one: numpy has no bf16, so
its two-byte values go into the ``.npz`` as raw ``V2`` items and the meta
names the dtype ``bfloat16``. The reference's own restore fails on such an
item (ROADMAP queue 3); this one reads the bits back as bf16.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from repro_torch.params import _to_tensor


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for dicts, lists and tuples, strings and
    ints: the same bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2 ** 8:
            out += bytes((0xD9, n))
        elif n < 2 ** 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_len(n: int, fix: int, tag16: int, out: bytearray) -> None:
    """An array's or map's header (``tag16 + 1`` is the 32-bit form)."""
    if n < 16:
        out.append(fix | n)
    elif n < 2 ** 16:
        out += bytes((tag16,)) + struct.pack(">H", n)
    else:
        out += bytes((tag16 + 1,)) + struct.pack(">I", n)


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                              (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if n < lim:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(n)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                              (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if -lim <= n:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(n)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def unpackb(data: bytes):
    """The inverse of :func:`packb` (``msgpack.unpackb`` on that
    subset)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the object")
    return obj


def _unpack(buf, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[i:i + n])[0], i + n
    if 0xA0 <= tag < 0xC0 or tag in (0xD9, 0xDA, 0xDB):
        if tag < 0xC0:
            n = tag & 0x1F
        else:
            width = {0xD9: 1, 0xDA: 2, 0xDB: 4}[tag]
            n = int.from_bytes(buf[i:i + width], "big")
            i += width
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if 0x80 <= tag < 0xA0 or tag in (0xDC, 0xDD, 0xDE, 0xDF):
        if tag < 0xA0:
            n, is_map = tag & 0x0F, tag < 0x90
        else:
            width = 2 if tag in (0xDC, 0xDE) else 4
            n = int.from_bytes(buf[i:i + width], "big")
            i += width
            is_map = tag in (0xDE, 0xDF)
        if is_map:
            out = {}
            for _ in range(n):
                k, i = _unpack(buf, i)
                out[k], i = _unpack(buf, i)
            return out, i
        items = []
        for _ in range(n):
            item, i = _unpack(buf, i)
            items.append(item)
        return items, i
    raise ValueError(f"msgpack type 0x{tag:02x} is not read here")


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{path: tensor}`` in the reference's leaf order: a dict's keys
    sorted (a flat parameter dict's ``/``-joined keys sort as the nested
    pytree's do), a named tuple's fields by name, a tuple's or list's
    items by index."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        items = [(join(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(join(f), getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(join(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, key))
    return out


def _unflatten(template, flat: dict, prefix: str = ""):
    """``template``'s structure with each leaf taken from ``flat``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(template, dict):
        return {k: _unflatten(v, flat, join(k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), flat,
                                           join(f))
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, flat, join(i))
                              for i, v in enumerate(template))
    return flat[prefix]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy: bf16 as ``V2`` items, as numpy saves the
    reference's bf16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


# ---------------------------------------------------------------------------
# Save and restore
# ---------------------------------------------------------------------------


def _map_trees(fn, tree):
    """``fn`` over each parameter dict or ``AdamWState`` of ``tree`` (one
    of them, or a tuple or list of them)."""
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(fn(t) for t in tree)
    return fn(tree)


def save_checkpoint(path: str, tree, step: int = 0, placement=None) -> None:
    """Write ``tree`` (a parameter dict, an ``AdamWState``, or dicts and
    tuples of them) to the directory ``path``. With ``placement`` (a
    training mesh's ``launch.sharding.TrainPlacement``) the leaves are
    this rank's blocks: every rank must call, every leaf is gathered
    whole, rank 0 writes, and every rank returns once the files are
    written."""
    if placement is not None:
        import torch.distributed as dist

        whole = _map_trees(placement.whole, tree)
        if dist.get_rank() == 0:
            save_checkpoint(path, whole, step)
        del whole
        dist.barrier()
        return
    os.makedirs(path, exist_ok=True)
    flat = _flatten_with_paths(tree)
    np.savez(os.path.join(path, "arrays.npz"),
             **{k: _to_numpy(v) for k, v in flat.items()})
    meta = {"step": int(step),
            "keys": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                     for k, v in flat.items()}}
    with open(os.path.join(path, "meta.msgpack"), "wb") as f:
        f.write(packb(meta))


def restore_checkpoint(path: str, template, placement=None):
    """(``template``'s structure filled from the checkpoint at ``path``, the
    step). Each leaf takes its template's dtype and device; a missing key
    or a shape that differs from the template's raises ``ValueError``.
    A template leaf on the ``meta`` device restores to the host. With
    ``placement`` the template holds whole leaves and each rank gets its
    blocks of them (``TrainPlacement.shard``)."""
    if placement is not None:
        whole, step = restore_checkpoint(path, template)
        return _map_trees(placement.shard, whole), step
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    flat_t = _flatten_with_paths(template)
    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = set(flat_t) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        for key, tmpl in flat_t.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: shape {arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            device = "cpu" if tmpl.device.type == "meta" else tmpl.device
            restored[key] = _to_tensor(arr).to(device, tmpl.dtype)
    return _unflatten(template, restored), meta["step"]

