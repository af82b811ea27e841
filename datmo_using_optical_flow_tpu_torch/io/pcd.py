"""PCD (Point Cloud Data) file reader and writer, a copy of
``datmo_using_optical_flow_tpu.io.pcd`` (the port imports nothing of the JAX
package; ``tests/test_torch_io.py`` holds the copy to the original).

The reference reads and writes point clouds through Open3D
(``Optical_flow/main.py:60``, ``single_target_simultion.py:312``).  This
module reads the three PCD 0.7 encodings, ``ascii``, ``binary`` and
``binary_compressed`` (LZF), with the optional C++ decoder of
``native/pcdio.cpp`` (``native/libpcdio.so``, loaded by ctypes when built)
and a numpy decoder otherwise, and writes ``ascii`` or ``binary``.  Only the
xyz fields are returned; extra fields (intensity etc.) are parsed and
discarded.
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass

import numpy as np

_FIELD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


@dataclass
class PcdHeader:
    fields: list[str]
    sizes: list[int]
    types: list[str]
    counts: list[int]
    width: int
    height: int
    points: int
    data: str  # "ascii" | "binary" | "binary_compressed"
    header_end: int  # byte offset where data begins


def _parse_header(buf: bytes) -> PcdHeader:
    fields: list[str] = []
    sizes: list[int] = []
    types: list[str] = []
    counts: list[int] = []
    width = height = points = -1
    data = ""
    offset = 0
    view = memoryview(buf)
    while True:
        nl = buf.find(b"\n", offset)
        if nl < 0:
            raise ValueError("PCD header truncated: no DATA line found")
        line = buf[offset:nl].decode("ascii", errors="replace").strip()
        offset = nl + 1
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        vals = rest.split()
        if key == "FIELDS":
            fields = vals
        elif key == "SIZE":
            sizes = [int(v) for v in vals]
        elif key == "TYPE":
            types = vals
        elif key == "COUNT":
            counts = [int(v) for v in vals]
        elif key == "WIDTH":
            width = int(vals[0])
        elif key == "HEIGHT":
            height = int(vals[0])
        elif key == "POINTS":
            points = int(vals[0])
        elif key == "DATA":
            data = vals[0].lower()
            break
    del view
    if not counts:
        counts = [1] * len(fields)
    if points < 0:
        points = width * height if width >= 0 and height >= 0 else 0
    if not fields or not sizes or not types:
        raise ValueError("PCD header missing FIELDS/SIZE/TYPE")
    if data not in ("ascii", "binary", "binary_compressed"):
        raise ValueError(f"unsupported PCD DATA encoding: {data!r}")
    return PcdHeader(fields, sizes, types, counts, width, height, points, data, offset)


def _lzf_decompress(src: bytes, expected: int) -> bytes:
    """Decompress LZF data (PCL binary_compressed encoding)."""
    out = bytearray(expected)
    i, o, n = 0, 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = src[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            length += 2
            for _ in range(length):  # may overlap; byte-by-byte
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != expected:
        raise ValueError(f"LZF decompression produced {o} bytes, expected {expected}")
    return bytes(out)


def _record_dtype(h: PcdHeader) -> np.dtype:
    entries = []
    for name, size, typ, count in zip(h.fields, h.sizes, h.types, h.counts):
        base = _FIELD_DTYPES.get((typ, size))
        if base is None:
            raise ValueError(f"unsupported PCD field type {typ}{size}")
        if count == 1:
            entries.append((name, base))
        else:
            entries.append((name, base, (count,)))
    return np.dtype(entries)


_native_lib = None
_native_checked = False


def _get_native():
    """Load the optional C++ decoder (built from native/pcdio.cpp)."""
    global _native_lib, _native_checked
    if _native_checked:
        return _native_lib
    _native_checked = True
    so = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "native", "libpcdio.so")
    if os.path.exists(so):
        try:
            lib = ctypes.CDLL(so)
            lib.pcdio_read_xyz.restype = ctypes.c_longlong
            lib.pcdio_read_xyz.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ]
            _native_lib = lib
        except OSError:
            _native_lib = None
    return _native_lib


def read_pcd(path: str, dtype=np.float64, use_native: bool = True) -> np.ndarray:
    """Read a PCD file and return an (N, 3) xyz array.

    Matches ``np.asarray(o3d.io.read_point_cloud(path).points)`` in the reference
    (``Optical_flow/main.py:60-61``): xyz only, float64 by default.
    """
    lib = _get_native() if use_native else None
    if lib is not None:
        # first call with capacity 0 returns the point count
        n = lib.pcdio_read_xyz(path.encode(), None, 0)
        if n >= 0:
            buf = np.empty((int(n), 3), dtype=np.float32)
            got = lib.pcdio_read_xyz(
                path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
            if got == n:
                return buf.astype(dtype, copy=False) if dtype != np.float32 else buf
        # negative => unsupported by native decoder; fall through to python

    with open(path, "rb") as f:
        buf = f.read()
    h = _parse_header(buf)
    rec = _record_dtype(h)

    if h.data == "ascii":
        text = buf[h.header_end:].decode("ascii", errors="replace")
        ncols = sum(h.counts)
        flat = np.array(text.split(), dtype=np.float64)
        flat = flat[: h.points * ncols].reshape(h.points, ncols)
        out = np.empty((h.points, 3), dtype=np.float64)
        col = 0
        colmap = {}
        for name, count in zip(h.fields, h.counts):
            colmap[name] = col
            col += count
        for i, axis in enumerate(("x", "y", "z")):
            out[:, i] = flat[:, colmap[axis]]
        return out.astype(dtype, copy=False)

    if h.data == "binary":
        raw = buf[h.header_end:h.header_end + rec.itemsize * h.points]
        arr = np.frombuffer(raw, dtype=rec, count=h.points)
        return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(dtype)

    # binary_compressed: u32 compressed size, u32 uncompressed size, LZF payload;
    # data is stored field-major (SoA), not record-major.
    comp_size, uncomp_size = struct.unpack_from("<II", buf, h.header_end)
    payload = buf[h.header_end + 8:h.header_end + 8 + comp_size]
    data = _lzf_decompress(payload, uncomp_size)
    out = np.empty((h.points, 3), dtype=np.float64)
    off = 0
    want = {"x": 0, "y": 1, "z": 2}
    for name, size, typ, count in zip(h.fields, h.sizes, h.types, h.counts):
        base = _FIELD_DTYPES[(typ, size)]
        nbytes = size * count * h.points
        if name in want and count == 1:
            col = np.frombuffer(data, dtype=base, count=h.points, offset=off)
            out[:, want[name]] = col
        off += nbytes
    return out.astype(dtype, copy=False)


def write_pcd(path: str, points: np.ndarray, data: str = "binary") -> None:
    """Write an (N, 3) xyz array as a PCD 0.7 file (``ascii`` or ``binary``).

    Capability parity with ``o3d.io.write_point_cloud`` as used by the simulator
    (``single_target_simultion.py:312``).
    """
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {points.shape}")
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {data}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if data == "ascii":
            np.savetxt(f, points, fmt="%.8g")
        elif data == "binary":
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            raise ValueError(f"unsupported write encoding {data!r}")
