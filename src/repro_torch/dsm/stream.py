"""Zero-copy streaming frame I/O — the port of ``repro.dsm.stream``.

The ``.cxl0`` frame format is shared with the JAX package byte for byte:
for identical leaf bytes both packages write identical files, and each
reads the other's (tests/test_torch_dsm.py).  Frame layout (all integers
little-endian)::

    0            MAGIC        b"CXL0FR1\\n"                     8 bytes
    8            header_len   u32
    12           header_crc   u32  (zlib.crc32 of the header JSON)
    16           header JSON  {"n": N, "dtypes": [...],
                               "shapes": [[...]], "nbytes": [...]}
    hdr_end      payload      every leaf's raw C-order bytes, tightly
                              concatenated (offsets = running sums)
    hdr_end+P    FOOTER       b"CXL0END\\n"                     8 bytes
    +8           payload_crc  u32  (zlib.crc32 folded over the payload)
    +12          payload_len  u64

Leaves are host torch tensors or numpy arrays.  Dtype tokens are numpy's
names (``"float32"``, ``"int32"``, ``"bool"``, ``"bfloat16"``, ...):
bfloat16 goes out as its raw 2-byte payload through an int16 view and
comes back through ``torch.frombuffer`` — no ``ml_dtypes`` on either side
of the port.  The reader returns host torch tensors that view a private
copy-on-write mapping of the file (``mmap.ACCESS_COPY``): zero-copy loads,
validated by the same incremental CRC fold as the reference.

Torn writes are detected exactly as in the reference: the size equation
(truncate), the folded payload CRC (bit flips, smears) and the header CRC
(a flipped dtype token can never silently re-type the data).
"""
from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import zlib
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.convert import TOKEN_TO_TORCH, raw_numpy

MAGIC = b"CXL0FR1\n"
FOOTER = b"CXL0END\n"
SUFFIX = ".cxl0"
#: CRC/write granularity for large leaves
CHUNK = 1 << 20
#: leaves below this are coalesced into the arena before hitting the file
PACK_LIMIT = 256 << 10
_FOOTER_LEN = len(FOOTER) + 4 + 8        # magic + u32 crc + u64 payload_len
_HDR_FIXED = len(MAGIC) + 4 + 4          # magic + u32 len + u32 crc


class FrameError(Exception):
    """Any structural or CRC validation failure of a frame — the caller
    (pool read path) treats it exactly like a torn write."""


class SpillArena:
    """Reusable spill-buffer arena: one geometrically-grown scratch buffer
    per thread, checked out by the frame writer to coalesce small leaves
    instead of allocating per commit."""

    MIN_BYTES = 1 << 20

    def __init__(self):
        self._local = threading.local()
        self.allocations = 0

    def checkout(self, nbytes: int) -> memoryview:
        buf = getattr(self._local, "buf", None)
        if buf is None or len(buf) < nbytes:
            size = max(self.MIN_BYTES,
                       len(buf) * 2 if buf is not None else 0, nbytes)
            buf = bytearray(size)
            self._local.buf = buf
            self.allocations += 1
        return memoryview(buf)


_DEFAULT_ARENA = SpillArena()


def _leaf_view(raw: np.ndarray) -> memoryview:
    """Raw bytes of a C-contiguous array as a memoryview (no copy, except
    for 0-d and empty arrays, which cannot be view-cast)."""
    if not raw.ndim or not raw.size:
        return memoryview(raw.tobytes())
    return memoryview(raw).cast("B")


def _host_leaf(a: Any) -> Tuple[np.ndarray, str]:
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        raise FrameError(f"frame leaves must be host tensors, got one on "
                         f"{a.device} (the tier layer copies D2H first)")
    return raw_numpy(a)


def frame_header(leaves: List[Any]) -> Dict[str, Any]:
    return _header([_host_leaf(a) for a in leaves])


def _header(raws: List[Tuple[np.ndarray, str]]) -> Dict[str, Any]:
    return {"n": len(raws), "dtypes": [tok for _, tok in raws],
            "shapes": [list(raw.shape) for raw, _ in raws],
            "nbytes": [int(raw.nbytes) for raw, _ in raws]}


def write_frame(f: BinaryIO, leaves: List[Any],
                arena: Optional[SpillArena] = None
                ) -> Tuple[int, int, Dict[str, Any]]:
    """Stream ``leaves`` into ``f`` as one frame; single pass, CRC folded
    chunk-by-chunk as the bytes are written.  Returns
    ``(payload_crc, payload_nbytes, header)``.  The caller owns fsync /
    rename."""
    arena = arena or _DEFAULT_ARENA
    raws = [_host_leaf(a) for a in leaves]
    header = _header(raws)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    f.write(MAGIC)
    f.write(struct.pack("<II", len(hdr), zlib.crc32(hdr)))
    f.write(hdr)
    crc = 0
    total = 0
    pack = arena.checkout(max(PACK_LIMIT * 2, CHUNK))
    pack_cap = len(pack) - PACK_LIMIT
    pos = 0
    for raw, _ in raws:
        mv = _leaf_view(raw)
        n = len(mv)
        total += n
        if n >= PACK_LIMIT:
            if pos:                             # flush the packed run
                crc = _fold(pack, pos, crc)
                f.write(pack[:pos])
                pos = 0
            for lo in range(0, n, CHUNK):
                part = mv[lo:lo + CHUNK]
                crc = zlib.crc32(part, crc)
                f.write(part)
        else:
            pack[pos:pos + n] = mv
            pos += n
            if pos >= pack_cap:
                crc = _fold(pack, pos, crc)
                f.write(pack[:pos])
                pos = 0
    if pos:
        crc = _fold(pack, pos, crc)
        f.write(pack[:pos])
    f.write(FOOTER)
    f.write(struct.pack("<IQ", crc, total))
    return crc, total, header


def _fold(mv: memoryview, end: int, crc: int) -> int:
    for lo in range(0, end, CHUNK):
        crc = zlib.crc32(mv[lo:min(lo + CHUNK, end)], crc)
    return crc


def read_header(path: str) -> Tuple[Dict[str, Any], int, int]:
    """Parse + validate ONLY the frame header of ``path``.  Returns
    ``(header, payload_offset, file_size)``."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            fixed = f.read(_HDR_FIXED)
            if len(fixed) != _HDR_FIXED or fixed[:len(MAGIC)] != MAGIC:
                raise FrameError(f"{path}: bad frame magic")
            hdr_len, hdr_crc = struct.unpack_from("<II", fixed, len(MAGIC))
            if _HDR_FIXED + hdr_len + _FOOTER_LEN > size:
                raise FrameError(f"{path}: truncated header")
            hdr = f.read(hdr_len)
    except OSError as e:
        raise FrameError(f"{path}: {e}") from e
    if len(hdr) != hdr_len or zlib.crc32(hdr) != hdr_crc:
        raise FrameError(f"{path}: header CRC mismatch")
    try:
        header = json.loads(hdr)
        n = header["n"]
        if not (len(header["dtypes"]) == len(header["shapes"])
                == len(header["nbytes"]) == n):
            raise ValueError("inconsistent header arity")
    except (ValueError, KeyError, TypeError) as e:
        raise FrameError(f"{path}: unparseable header: {e}") from e
    return header, _HDR_FIXED + hdr_len, size


def read_frame(path: str, expected_crc: Optional[int] = None
               ) -> Tuple[List[torch.Tensor], int, Dict[str, Any]]:
    """mmap-backed zero-copy read of one frame: validate structure + the
    folded CRC, then return host tensors viewing the mapping plus
    ``(payload_crc, header)``.  Raises FrameError on ANY mismatch,
    including ``expected_crc`` when given."""
    header, payload_off, size = read_header(path)
    payload = sum(header["nbytes"])
    if payload_off + payload + _FOOTER_LEN != size:
        raise FrameError(f"{path}: size mismatch (torn write?)")
    try:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    except (OSError, ValueError) as e:
        raise FrameError(f"{path}: {e}") from e
    foot_off = payload_off + payload
    if mm[foot_off:foot_off + len(FOOTER)] != FOOTER:
        raise FrameError(f"{path}: bad footer magic")
    crc_stored, len_stored = struct.unpack_from(
        "<IQ", mm, foot_off + len(FOOTER))
    if len_stored != payload:
        raise FrameError(f"{path}: footer/header payload length mismatch")
    crc = 0
    with memoryview(mm) as view:
        for lo in range(payload_off, foot_off, CHUNK):
            crc = zlib.crc32(view[lo:min(lo + CHUNK, foot_off)], crc)
    if crc != crc_stored:
        raise FrameError(f"{path}: payload CRC mismatch")
    if expected_crc is not None and crc != expected_crc:
        raise FrameError(
            f"{path}: content does not match the recorded CRC "
            f"(overwritten by a later write?)")
    tensors: List[torch.Tensor] = []
    off = payload_off
    try:
        for tok, shape, nb in zip(header["dtypes"], header["shapes"],
                                  header["nbytes"]):
            dt = TOKEN_TO_TORCH[tok]
            count = nb // dt.itemsize
            if count != int(np.prod(shape)) or count * dt.itemsize != nb:
                raise ValueError(f"{nb} bytes cannot hold {tok}{shape}")
            if count == 0:
                t = torch.empty(shape, dtype=dt)
            else:
                t = torch.frombuffer(mm, dtype=dt, count=count,
                                     offset=off).reshape(shape)
            tensors.append(t)
            off += nb
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise FrameError(f"{path}: undecodable leaf: {e}") from e
    return tensors, crc, header
