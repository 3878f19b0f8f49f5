"""``.npz`` files written and read at the disk's speed, in ``np.savez``'s
format (``np.load`` reads what `write_npz` writes, and `read_npz` reads
what ``np.savez`` writes).

``np.savez`` copies every array into bytes and computes the zip's CRC-32
on one thread as it writes; ``np.load`` reads a member in 256 KiB pieces
and checks its CRC the same way, about 0.5 GB/s each way.  Here each
member is an uncompressed (stored) zip64 entry, as ``np.savez`` makes it:
the CRCs are computed on a thread pool (``zlib.crc32`` lets go of the
GIL) while the members are written from the arrays' own buffers in
order; reading, each member's bytes go straight into its array with
``os.preadv`` and its CRC is checked on the pool.  A file with a
compressed or encrypted member, or an npy header past version 2.0, is
read by ``np.load`` instead.
"""
from __future__ import annotations

import concurrent.futures
import io
import os
import struct
import time
import zipfile
import zlib

import numpy as np

_WORKERS = min(8, os.cpu_count() or 1)
_MAX32 = 0xFFFFFFFF
_ZIP64_VERSION = 45
_LOCAL = struct.Struct("<4s2B4HL2L2H")     # zipfile.structFileHeader
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")  # zipfile.structCentralDir
_EOCD64 = struct.Struct("<4sQ2H2L4Q")
_LOCATOR64 = struct.Struct("<4sLQL")
_EOCD = struct.Struct("<4s4H2LH")


def _npy_bytes(arr: np.ndarray):
    """``(npy header bytes, the data as a flat uint8 array)``."""
    arr = np.asarray(arr, order="C")
    if arr.dtype.hasobject:
        raise ValueError("object arrays are not saved (np.load refuses "
                         "them without allow_pickle)")
    head = io.BytesIO()
    d = np.lib.format.header_data_from_array_1_0(arr)
    try:
        np.lib.format.write_array_header_1_0(head, d)
    except ValueError:
        head = io.BytesIO()
        np.lib.format.write_array_header_2_0(head, d)
    return head.getvalue(), arr.reshape(-1).view(np.uint8)


def _crc(head: bytes, data: np.ndarray) -> int:
    return zlib.crc32(data, zlib.crc32(head))


def _dos_time() -> tuple:
    t = time.localtime(time.time())
    return ((t.tm_hour << 11) | (t.tm_min << 5) | (t.tm_sec // 2),
            ((t.tm_year - 1980) << 9) | (t.tm_mon << 5) | t.tm_mday)


def write_npz(path: str, arrays: dict) -> None:
    """Write ``arrays`` (name -> array) to ``path`` as ``np.savez(path,
    **arrays)`` would (a member ``<name>.npy`` each, stored, zip64)."""
    members = [(name, *_npy_bytes(np.asarray(a))) for name, a in
               arrays.items()]
    dostime, dosdate = _dos_time()
    central = []
    with concurrent.futures.ThreadPoolExecutor(_WORKERS) as pool, \
            open(path, "wb") as f:
        crcs = [pool.submit(_crc, head, data) for _, head, data in members]
        for (name, head, data), crc in zip(members, crcs):
            raw = (name + ".npy").encode("utf-8")
            flags = 0 if raw.isascii() else 0x800
            size = len(head) + data.nbytes
            offset = f.tell()
            extra = struct.pack("<2H2Q", 1, 16, size, size)
            crc = crc.result()
            f.write(_LOCAL.pack(b"PK\x03\x04", _ZIP64_VERSION, 0, flags,
                                zipfile.ZIP_STORED, dostime, dosdate, crc,
                                _MAX32, _MAX32, len(raw), len(extra)))
            f.write(raw)
            f.write(extra)
            f.write(head)
            f.write(memoryview(data))
            central.append((raw, flags, crc, size, offset))
        cd_start = f.tell()
        for raw, flags, crc, size, offset in central:
            extra = struct.pack("<2H3Q", 1, 24, size, size, offset)
            f.write(_CENTRAL.pack(
                b"PK\x01\x02", _ZIP64_VERSION, 3, _ZIP64_VERSION, 0,
                flags, zipfile.ZIP_STORED, dostime, dosdate, crc, _MAX32,
                _MAX32, len(raw), len(extra), 0, 0, 0, 0o600 << 16,
                _MAX32))
            f.write(raw)
            f.write(extra)
        cd_end = f.tell()
        n, cd_size = len(central), cd_end - cd_start
        f.write(_EOCD64.pack(b"PK\x06\x06", _EOCD64.size - 12,
                             _ZIP64_VERSION, _ZIP64_VERSION, 0, 0, n, n,
                             cd_size, cd_start))
        f.write(_LOCATOR64.pack(b"PK\x06\x07", 0, cd_end, 1))
        f.write(_EOCD.pack(b"PK\x05\x06", 0, 0, min(n, 0xFFFF),
                           min(n, 0xFFFF), min(cd_size, _MAX32),
                           min(cd_start, _MAX32), 0))


def _pread_into(fd: int, buf: memoryview, offset: int) -> None:
    done = 0
    while done < len(buf):
        n = os.preadv(fd, [buf[done:]], offset + done)
        if n <= 0:
            raise OSError(f"short read at byte {offset + done}")
        done += n


class _Unsupported(Exception):
    """A member this reader leaves to ``np.load``."""


def _read_member(fd: int, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored member's array, its CRC checked."""
    local = os.pread(fd, _LOCAL.size, info.header_offset)
    fields = _LOCAL.unpack(local)
    if fields[0] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"bad local header for {info.filename}")
    start = info.header_offset + _LOCAL.size + fields[-2] + fields[-1]
    # the npy header: magic, version, header length, the header dict
    pre = os.pread(fd, 12, start)
    fp = io.BytesIO(pre)
    version = np.lib.format.read_magic(fp)
    if version not in ((1, 0), (2, 0)):
        raise _Unsupported(version)
    hlen_size = 2 if version == (1, 0) else 4
    hlen = int.from_bytes(pre[8:8 + hlen_size], "little")
    head = os.pread(fd, 8 + hlen_size + hlen, start)
    shape, fortran, dtype = (
        np.lib.format.read_array_header_1_0 if version == (1, 0)
        else np.lib.format.read_array_header_2_0)(io.BytesIO(head[8:]))
    if dtype.hasobject:
        raise ValueError(f"{info.filename}: object arrays need "
                         f"allow_pickle")
    arr = np.empty(shape, dtype, order="F" if fortran else "C")
    data = arr.reshape(-1, order="A").view(np.uint8)
    if len(head) + data.nbytes != info.file_size:
        raise zipfile.BadZipFile(f"{info.filename}: size mismatch")
    _pread_into(fd, memoryview(data), start + len(head))
    if _crc(head, data) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return arr


def read_npz(path: str) -> dict:
    """``{name: array}`` of an ``.npz`` file, as ``np.load(path)`` gives
    them (``allow_pickle=False``)."""
    with open(path, "rb") as f:
        with zipfile.ZipFile(f) as zf:
            infos = zf.infolist()
        if any(i.compress_type != zipfile.ZIP_STORED or i.flag_bits & 0x1
               or not i.filename.endswith(".npy") for i in infos):
            with np.load(path, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        fd = f.fileno()
        try:
            with concurrent.futures.ThreadPoolExecutor(_WORKERS) as pool:
                arrays = list(pool.map(lambda i: _read_member(fd, i),
                                       infos))
        except _Unsupported:
            with np.load(path, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
    return {i.filename[:-4]: a for i, a in zip(infos, arrays)}
