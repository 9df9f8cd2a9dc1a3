"""Checkpoints of parameter and optimizer trees (port of
``repro/checkpoint/manager.py``), with the reference's properties:

* atomicity — a checkpoint is written to ``step_K.tmp-<pid>`` and then
  ``os.replace``-d to ``step_K``, so a writer that dies never corrupts the
  latest checkpoint;
* integrity — ``manifest.json`` holds each leaf's shape, dtype and the
  first 16 hex digits of its sha256, verified on restore;
* async — ``CheckpointManager.save(..., blocking=False)`` copies the tree to
  the host at once (the optimizer updates its buffers in place, so the copy
  must be complete before the next step) and hands only that host copy to a
  writer thread; the thread's error surfaces at the next ``wait()``;
* retention — keep-last-k;
* restore onto a device — leaves go back as tensors of the template's dtype
  on the given device (default: where each template leaf lies).

The on-disk format is the reference's: one uncompressed ``arrays.npz`` a
step, keyed by the ``/``-joined tree path (dict keys sorted, list
indices), and the same manifest keys, so a checkpoint either package
writes restores in the other bit for bit. The port writes and reads that
zip itself, a leaf a thread: ``np.savez`` and ``np.load`` take one leaf
after another through zipfile's CRC, several times slower than parallel
writes and reads on a many-core host (PERF.md has the figures for the 8.1
GB of a bika smollm-360m state). Each thread hashes its leaf, takes the
zip CRC-32 and writes the leaf at its precomputed offset; on restore each
reads its leaf straight into an array and checks its hash against the
manifest (the sha256 covers what the CRC would). Device leaves go to the
host through pinned buffers (PyTorch's caching host allocator keeps them
for the next save). A Python ``int`` leaf (the
optimizer's step counter) is stored as a 0-d int32, as the reference's
counter is, and restored as an ``int``. numpy has no bfloat16 (the
reference's leaves of that dtype go through ``ml_dtypes``): saving a
bfloat16 leaf raises instead of choosing an encoding the reference might
not read back.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
# leaves are hashed on a few threads: hashlib releases the GIL on large buffers
_HASH_WORKERS = max(1, min(8, os.cpu_count() or 1))
_INT32 = np.iinfo(np.int32)


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted, lists
    by index, paths joined with ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, f"{prefix}/{k}" if prefix else str(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def _to_host(key: str, leaf) -> np.ndarray:
    """A complete host copy of one leaf (never a view of a buffer that the
    next optimizer step may overwrite). A CUDA leaf is copied into a pinned
    buffer without waiting; ``_host_tree`` waits for all of them."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(
                f"checkpoint leaf {key!r} is {leaf.dtype}: numpy has no such dtype, so it "
                "has no encoding the reference reads back; keep the tree in float32")
        leaf = leaf.detach()
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
        buf.copy_(leaf, non_blocking=leaf.is_cuda)
        try:
            return buf.numpy()
        except TypeError as e:  # float8 and other dtypes numpy lacks
            raise ValueError(f"checkpoint leaf {key!r} is {leaf.dtype}: {e}") from e
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        if not _INT32.min <= leaf <= _INT32.max:
            raise ValueError(f"checkpoint leaf {key!r} = {leaf} does not fit an int32")
        return np.asarray(leaf, np.int32)  # the reference's step counter is int32
    return np.array(leaf, copy=True)


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]


def _parallel(fn, items: List) -> List:
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(_HASH_WORKERS) as pool:
        return list(pool.map(fn, items))


def _host_tree(tree) -> Dict[str, np.ndarray]:
    host = {k: _to_host(k, v) for k, v in _flatten_with_paths(tree)}
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the pinned copies are complete
    return host


# -- the npz container: an uncompressed zip of .npy members, zip64 ----------

_NO32 = 0xFFFFFFFF  # a 32-bit field whose value is in the zip64 extra field
_DOS_DATE = (0 << 9) | (1 << 5) | 1  # 1980-01-01


def _bytes_of(arr: np.ndarray) -> memoryview:
    return memoryview(arr.reshape(-1).view(np.uint8))


def _npy_header(arr: np.ndarray) -> bytes:
    fh = io.BytesIO()
    meta = np.lib.format.header_data_from_array_1_0(arr)
    try:
        np.lib.format.write_array_header_1_0(fh, meta)
    except ValueError:  # a header longer than 64 KiB
        fh = io.BytesIO()
        np.lib.format.write_array_header_2_0(fh, meta)
    return fh.getvalue()


def _local_header(name: bytes, crc: int, size: int) -> bytes:
    flags = 0x800 if any(c > 127 for c in name) else 0
    zip64 = struct.pack("<HHQQ", 1, 16, size, size)
    return struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, flags, 0, 0, _DOS_DATE, crc, _NO32,
                       _NO32, len(name), len(zip64)) + name + zip64


def _central_entry(name: bytes, crc: int, size: int, offset: int) -> bytes:
    flags = 0x800 if any(c > 127 for c in name) else 0
    zip64 = struct.pack("<HHQQQ", 1, 24, size, size, offset)
    return struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, (3 << 8) | 45, 45, flags, 0, 0,
                       _DOS_DATE, crc, _NO32, _NO32, len(name), len(zip64), 0, 0, 0,
                       0o600 << 16, _NO32) + name + zip64


def _end_records(n: int, cd_offset: int, cd_size: int) -> bytes:
    eocd64 = struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n, cd_size, cd_offset)
    locator = struct.pack("<IIQI", 0x07064B50, 0, cd_offset + cd_size, 1)
    eocd = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                       min(cd_size, _NO32), _NO32, 0)
    return eocd64 + locator + eocd


def _pwrite_all(fd: int, data, offset: int) -> None:
    view = memoryview(data)
    while view.nbytes:
        n = os.pwrite(fd, view, offset)
        view, offset = view[n:], offset + n


def _pread_into(fd: int, view: memoryview, offset: int) -> None:
    while view.nbytes:
        n = os.preadv(fd, [view], offset)
        if n <= 0:
            raise IOError("checkpoint truncated")
        view, offset = view[n:], offset + n


def _write_npz(path: str, host: Dict[str, np.ndarray]) -> List[str]:
    """Write ``host`` as ``np.savez`` would lay it out (member ``<key>.npy``
    a leaf, stored, zip64), a leaf a thread; returns the leaves' hashes."""
    keys = list(host)
    # C order, keeping a 0-d leaf 0-d (np.ascontiguousarray would make it (1,))
    arrays = [np.array(host[k], order="C", copy=not host[k].flags.c_contiguous)
              for k in keys]
    names = [(k + ".npy").encode("utf-8") for k in keys]
    headers = [_npy_header(a) for a in arrays]
    offsets, at = [], 0
    for name, head, arr in zip(names, headers, arrays):
        offsets.append(at)
        at += len(_local_header(name, 0, 0)) + len(head) + arr.nbytes
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        def one(i):
            data = _bytes_of(arrays[i])
            crc = zlib.crc32(data, zlib.crc32(headers[i]))
            size = len(headers[i]) + arrays[i].nbytes
            head = _local_header(names[i], crc, size) + headers[i]
            _pwrite_all(fd, head, offsets[i])
            _pwrite_all(fd, data, offsets[i] + len(head))
            return hashlib.sha256(arrays[i]).hexdigest()[:16], crc

        done = _parallel(one, list(range(len(keys))))
        central = b"".join(_central_entry(name, crc, len(head) + arr.nbytes, off)
                           for name, (_, crc), head, arr, off
                           in zip(names, done, headers, arrays, offsets))
        _pwrite_all(fd, central + _end_records(len(keys), at, len(central)), at)
    finally:
        os.close(fd)
    return [h for h, _ in done]


def _read_npz(path: str, keys: List[str], pinned: bool):
    """The arrays of ``keys`` from an ``np.savez``-layout file (either
    package's), read straight into arrays a leaf a thread, with their
    hashes. ``pinned``: into pinned host memory, for a copy to the card."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename: i for i in zf.infolist()}
    fd = os.open(path, os.O_RDONLY)
    try:
        def one(key):
            info = infos.get(key + ".npy")
            if info is None:
                raise KeyError(f"{key} is not in {path}")
            if info.compress_type != zipfile.ZIP_STORED:
                raise IOError(f"{key} is compressed in {path}; checkpoints are stored")
            local = os.pread(fd, 30, info.header_offset)
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + name_len + extra_len
            fh = io.BytesIO(os.pread(fd, min(info.file_size, 1 << 16), start))
            version = np.lib.format.read_magic(fh)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(fh)
            if dtype.hasobject:
                raise IOError(f"{key} in {path} holds Python objects")
            shape = tuple(shape)
            if pinned:
                arr = torch.empty(shape[::-1] if fortran else shape,
                                  dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                  pin_memory=True).numpy()
            else:
                arr = np.empty(shape[::-1] if fortran else shape, dtype)
            if fh.tell() + arr.nbytes != info.file_size:
                raise IOError(f"{key} in {path}: its header and its size disagree")
            _pread_into(fd, _bytes_of(arr), start + fh.tell())
            arr = arr.T if fortran else arr
            return arr, _hash(arr)

        return _parallel(one, keys)
    finally:
        os.close(fd)


def _write(directory: str, step: int, host: Dict[str, np.ndarray],
           extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    hashes = _write_npz(os.path.join(tmp, "arrays.npz"), host)
    manifest = {
        "step": int(step),
        "extra": extra or {},
        "arrays": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype), "hash": h}
            for (k, v), h in zip(host.items(), hashes)
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, sort_keys=True)
    if os.path.exists(final):  # an idempotent re-save of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree, *, extra: Optional[Dict] = None) -> str:
    """Write one checkpoint synchronously; returns its final path."""
    return _write(directory, step, _host_tree(tree), extra)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(directory)
        if (m := _STEP_RE.match(d)) and os.path.exists(os.path.join(directory, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _from_host(key: str, arr: np.ndarray, tpl, device):
    """One restored array -> a leaf like the template's."""
    if isinstance(tpl, torch.Tensor):
        want = torch.empty((), dtype=tpl.dtype).numpy().dtype
        if arr.dtype != want:
            raise ValueError(f"dtype mismatch for {key}: ckpt {arr.dtype} vs template {tpl.dtype}")
        dev = tpl.device if device is None else torch.device(device)
        return torch.from_numpy(arr).to(dev, non_blocking=dev.type == "cuda")
    if isinstance(tpl, (bool, int, float)):
        if arr.shape != ():
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs a scalar template")
        return type(tpl)(arr.item())
    return arr


def restore(directory: str, step: Optional[int], template, *, device=None,
            verify: bool = True):
    """Restore a ``template``-shaped tree from ``step`` (None: the latest).
    Returns ``(tree, manifest)``; tensor leaves come back with the
    template's dtype on ``device`` (None: each template leaf's device)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _flatten_with_paths(template)
    to_card = any(isinstance(t, torch.Tensor) and (t.is_cuda if device is None
                                                   else torch.device(device).type == "cuda")
                  for _, t in flat_t)
    read = _read_npz(os.path.join(path, "arrays.npz"), [k for k, _ in flat_t], to_card)
    out: Dict[str, Any] = {}
    for (k, tpl), (arr, digest) in zip(flat_t, read):
        meta = manifest["arrays"][k]
        if verify and digest != meta["hash"]:
            raise IOError(f"checkpoint corruption: hash mismatch for {k} in {path}")
        shape = tuple(tpl.shape) if hasattr(tpl, "shape") else ()
        if shape != arr.shape:
            raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} vs template {shape}")
        out[k] = _from_host(k, arr, tpl, device)
    if to_card:
        torch.cuda.synchronize()  # the copies from the pinned buffers are complete
    return _unflatten(template, out), manifest


class CheckpointManager:
    """Async keep-last-k manager around ``save`` / ``restore``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree, *, extra=None, blocking: bool = True) -> None:
        self.wait()  # one save in flight at a time
        # the host copy is complete before this returns: the caller may
        # update the tree's buffers in place afterwards
        host = _host_tree(tree)

        def work():
            try:
                _write(self.directory, step, host, extra)
                self._gc()
            except Exception as e:  # surfaced at the next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template, *, device=None):
        self.wait()
        return restore(self.directory, None, template, device=device)

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
