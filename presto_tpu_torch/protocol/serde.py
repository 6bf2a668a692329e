"""SerializedPage wire codec: the page-frame half that spill files need.

The port's copy of presto_tpu/protocol/serde.py, byte for byte the same
frames. Wire layout (little-endian; reference:
presto-spi/.../page/PagesSerdeUtil.java:64-90 write/readSerializedPage):

    positionCount      int32
    pageCodecMarkers   byte   (COMPRESSED=1, ENCRYPTED=2, CHECKSUMMED=4;
                               the codec id in the spare high bits)
    uncompressedSize   int32
    sizeInBytes        int32  (length of the payload that follows)
    checksum           int64  (CRC32 of payload+markers+positionCount+
                               uncompressedSize when CHECKSUMMED)
    payload            bytes: int32 numBlocks, then per block a
                       length-prefixed encoding name + encoding body
                       (bit-packed null flags, MSB first)

Ported: `WireBlock` (:86), `PageBuffer` and the scatter-gather
`_PageWriter`, the block encoders and decoders (LONG_ARRAY, INT_ARRAY,
SHORT_ARRAY, BYTE_ARRAY, INT128_ARRAY, VARIABLE_WIDTH, ARRAY, MAP, ROW,
RLE, DICTIONARY; :139-462), the checksums (:463-482),
`encode_page_buffer` (:483), `encode_serialized_page` (:549), the
none/zlib/gzip/lz4 codecs (:556-608), `decode_serialized_page` (:609),
and the engine page conversions `page_to_wire_blocks` (:727) and
`wire_blocks_to_page` (:838), over torch columns. LZ4 and the CRC run in
the host codec library (csrc/page_codec.cc via native.py); without it the
CRC is zlib's (the same value) and lz4 raises, as in the JAX package.
The JAX module's metrics counters and its native null packer are left
out (numpy packs the same bits). The rest of the JAX module (the worker
path's exchange helpers) is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

COMPRESSED = 1
ENCRYPTED = 2
CHECKSUMMED = 4
#: codec id carried in the marker byte's spare high bits (0 = unmarked
#: legacy frame -> magic-byte sniffing)
_CODEC_SHIFT = 4
_CODEC_BITS = {"zlib": 1 << _CODEC_SHIFT, "gzip": 2 << _CODEC_SHIFT,
               "lz4": 3 << _CODEC_SHIFT}
_CODEC_BY_ID = {1: "zlib", 2: "gzip", 3: "lz4"}

_HEADER = struct.Struct("<ibiiq")


@dataclasses.dataclass
class WireBlock:
    """Decoded block: fixed-width values + null mask, or nested forms."""
    encoding: str
    values: Optional[np.ndarray] = None      # fixed-width lanes
    nulls: Optional[np.ndarray] = None       # bool, True = NULL
    # VARIABLE_WIDTH: values is dtype=object array of bytes
    # DICTIONARY: ids in values, dictionary block nested
    dictionary: Optional["WireBlock"] = None
    # RLE: single-position value block + count
    rle_value: Optional["WireBlock"] = None
    count: int = 0
    # ARRAY: children=[elements]; MAP: children=[keys, values];
    # ROW: children=[field0, field1, ...] — with per-position offsets
    # (n+1 int32, rebased to 0, reference ArrayBlockEncoding.java layout)
    children: Optional[List["WireBlock"]] = None
    offsets: Optional[np.ndarray] = None

    @property
    def position_count(self) -> int:
        if self.encoding == "RLE":
            return self.count
        if self.offsets is not None:
            return len(self.offsets) - 1
        return len(self.values)


class PageBuffer:
    """One page, one allocation: the full encoded frame (21-byte header
    + payload) in a single pre-sized buffer plus a payload-relative
    offsets table locating each block; `to_bytes()` copies it out."""

    __slots__ = ("buffer", "block_offsets", "position_count")

    def __init__(self, buffer: bytearray, block_offsets: Tuple[int, ...],
                 position_count: int):
        self.buffer = buffer
        self.block_offsets = block_offsets
        self.position_count = position_count

    def to_bytes(self) -> bytes:
        return bytes(self.buffer)


class _PageWriter:
    """Scatter-gather payload writer. Small struct-packed pieces
    coalesce into pending byte runs; numpy lanes are recorded by
    REFERENCE and written straight into the single page buffer at
    emission time (`write_into`). Exactly one copy per lane."""

    #: lanes under this many bytes ride the coalesced byte run: a
    #: part-table entry costs more than the copy it saves
    _SMALL = 64

    __slots__ = ("_parts", "_pending", "_size")

    def __init__(self):
        self._parts: List[Tuple[int, object]] = []
        self._pending = bytearray()
        self._size = 0

    @property
    def size(self) -> int:
        return self._size

    def put(self, piece: bytes):
        self._pending += piece
        self._size += len(piece)

    def put_bytes(self, piece: bytes):
        """A pre-built byte string; large ones are emitted by reference."""
        if len(piece) < self._SMALL:
            self.put(piece)
            return
        self._flush()
        self._parts.append((self._size, piece))
        self._size += len(piece)

    def put_array(self, a: np.ndarray):
        a = np.ascontiguousarray(a)
        if a.nbytes < self._SMALL:
            self.put(a.tobytes())
            return
        self._flush()
        self._parts.append((self._size, a))
        self._size += a.nbytes

    def _flush(self):
        if self._pending:
            self._parts.append(
                (self._size - len(self._pending), bytes(self._pending)))
            self._pending = bytearray()

    def write_into(self, mv: memoryview, base: int):
        """Scatter every recorded part into `mv` at `base` + offset."""
        self._flush()
        for off, part in self._parts:
            o = base + off
            if isinstance(part, np.ndarray):
                dst = np.frombuffer(mv, dtype=part.dtype,
                                    count=part.size, offset=o)
                dst.reshape(part.shape)[...] = part
            else:
                mv[o:o + len(part)] = part


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _encode_nulls(w: _PageWriter, nulls: Optional[np.ndarray], n: int):
    """EncoderUtil.encodeNullsAsBits: hasNulls byte then MSB-first bits
    (numpy's packbits: the same bytes as the JAX package's native
    packer)."""
    if nulls is None or not nulls.any():
        w.put(b"\x00")
        return
    w.put(b"\x01")
    w.put_array(np.packbits(nulls[:n].astype(np.uint8)))  # MSB-first


def _decode_nulls(buf: memoryview, off: int, n: int
                  ) -> Tuple[Optional[np.ndarray], int]:
    has = buf[off]
    off += 1
    if not has:
        return None, off
    nbytes = (n + 7) // 8
    bits = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=off)
    nulls = np.unpackbits(bits, count=n).astype(bool)
    nulls.setflags(write=False)
    return nulls, off + nbytes


def _view(buf: memoryview, off: int, dtype, count: int) -> np.ndarray:
    """A read-only numpy view over `count` items of `buf` at `off`; the
    view's .base pins the frame buffer alive (zero-copy decode)."""
    return np.frombuffer(buf, dtype=dtype, count=count, offset=off)


def _fixed_width_encode(w: _PageWriter, b: WireBlock, dtype, width: int):
    n = len(b.values)
    w.put(struct.pack("<i", n))
    _encode_nulls(w, b.nulls, n)
    vals = np.ascontiguousarray(b.values, dtype=dtype)
    if b.nulls is not None and b.nulls.any():
        vals = vals[~b.nulls]          # Java writes only non-null slots
    w.put_array(vals)


def _fixed_width_decode(buf: memoryview, off: int, dtype, width: int
                        ) -> Tuple[WireBlock, int]:
    (n,) = struct.unpack_from("<i", buf, off)
    off += 4
    nulls, off = _decode_nulls(buf, off, n)
    if nulls is None:
        vals = _view(buf, off, dtype, n)
        off += n * width
    else:
        # null scatter — the wire carries only non-null slots, so the
        # full lane must be rebuilt (sanctioned copy)
        k = int((~nulls).sum())
        packed = _view(buf, off, dtype, k)
        off += k * width
        vals = np.zeros(n, dtype=dtype)
        vals[~nulls] = packed
        vals.setflags(write=False)
    return WireBlock("", vals, nulls), off


# ---------------------------------------------------------------------------
# per-encoding codecs
# ---------------------------------------------------------------------------

_FIXED = {"LONG_ARRAY": (np.int64, 8), "INT_ARRAY": (np.int32, 4),
          "SHORT_ARRAY": (np.int16, 2), "BYTE_ARRAY": (np.uint8, 1)}


def _encode_block(w: _PageWriter, b: WireBlock):
    name = b.encoding.encode()
    w.put(struct.pack("<i", len(name)))
    w.put(name)
    if b.encoding in _FIXED:
        dtype, width = _FIXED[b.encoding]
        _fixed_width_encode(w, b, dtype, width)
    elif b.encoding == "INT128_ARRAY":
        # two int64 lanes per position (values shape [n, 2]: low, high)
        n = len(b.values)
        w.put(struct.pack("<i", n))
        _encode_nulls(w, b.nulls, n)
        vals = np.ascontiguousarray(b.values, dtype=np.int64)
        if b.nulls is not None and b.nulls.any():
            vals = vals[~b.nulls]
        w.put_array(vals)
    elif b.encoding == "VARIABLE_WIDTH":
        n = len(b.values)
        w.put(struct.pack("<i", n))
        lens = np.array([0 if v is None else len(v) for v in b.values],
                        dtype=np.int64)
        w.put_array(np.cumsum(lens).astype(np.int32))
        _encode_nulls(w, b.nulls, n)
        payload = b"".join(v for v in b.values if v is not None)
        w.put(struct.pack("<i", len(payload)))
        w.put_bytes(payload)
    elif b.encoding == "ARRAY":
        # reference ArrayBlockEncoding.java: elements block, then
        # positionCount, offsets[n+1] rebased to 0, null bits
        n = b.position_count
        _encode_block(w, b.children[0])
        w.put(struct.pack("<i", n))
        w.put_array(np.ascontiguousarray(b.offsets, dtype=np.int32))
        _encode_nulls(w, b.nulls, n)
    elif b.encoding == "MAP":
        # reference MapBlockEncoding.java: key block, value block,
        # hashtable length (-1 = absent; readers rebuild lazily),
        # positionCount, offsets[n+1], null bits
        n = b.position_count
        _encode_block(w, b.children[0])
        _encode_block(w, b.children[1])
        w.put(struct.pack("<i", -1))
        w.put(struct.pack("<i", n))
        w.put_array(np.ascontiguousarray(b.offsets, dtype=np.int32))
        _encode_nulls(w, b.nulls, n)
    elif b.encoding == "ROW":
        # reference RowBlockEncoding.java: numFields, field blocks,
        # positionCount, fieldBlockOffsets[n+1], null bits
        n = b.position_count
        w.put(struct.pack("<i", len(b.children)))
        for child in b.children:
            _encode_block(w, child)
        w.put(struct.pack("<i", n))
        w.put_array(np.ascontiguousarray(b.offsets, dtype=np.int32))
        _encode_nulls(w, b.nulls, n)
    elif b.encoding == "RLE":
        w.put(struct.pack("<i", b.count))
        _encode_block(w, b.rle_value)
    elif b.encoding == "DICTIONARY":
        n = len(b.values)
        w.put(struct.pack("<i", n))
        _encode_block(w, b.dictionary)
        w.put_array(np.ascontiguousarray(b.values, dtype=np.int32))
        # dictionary instance id (most/least significant bits, sequence);
        # receivers only use it for caching — send a fixed id
        w.put(struct.pack("<qqq", 0, 0, 0))
    else:
        raise ValueError(f"unsupported encoding {b.encoding}")


def _decode_block(buf: memoryview, off: int) -> Tuple[WireBlock, int]:
    (name_len,) = struct.unpack_from("<i", buf, off)
    off += 4
    name = bytes(buf[off:off + name_len]).decode()
    off += name_len
    if name in _FIXED:
        dtype, width = _FIXED[name]
        b, off = _fixed_width_decode(buf, off, dtype, width)
        b.encoding = name
        return b, off
    if name == "INT128_ARRAY":
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        nulls, off = _decode_nulls(buf, off, n)
        if nulls is None:
            vals = _view(buf, off, np.int64, 2 * n).reshape(n, 2)
            off += n * 16
            return WireBlock(name, vals, None), off
        k = int((~nulls).sum())
        packed = _view(buf, off, np.int64, 2 * k).reshape(k, 2)
        off += k * 16
        vals = np.zeros((n, 2), dtype=np.int64)
        vals[~nulls] = packed
        vals.setflags(write=False)
        return WireBlock(name, vals, nulls), off
    if name == "VARIABLE_WIDTH":
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        offsets = _view(buf, off, np.int32, n)
        off += 4 * n
        nulls, off = _decode_nulls(buf, off, n)
        (total,) = struct.unpack_from("<i", buf, off)
        off += 4
        # per-value bytes objects: downstream string decode needs real
        # bytes (`.decode()`), so this lane is a sanctioned copy
        payload = bytes(buf[off:off + total])
        off += total
        vals = np.empty(n, dtype=object)
        prev = 0
        for i in range(n):
            end = int(offsets[i])
            if nulls is not None and nulls[i]:
                vals[i] = None
            else:
                vals[i] = payload[prev:end]
            prev = end
        vals.setflags(write=False)
        return WireBlock(name, vals, nulls), off
    if name == "ARRAY":
        elements, off = _decode_block(buf, off)
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        offsets = _view(buf, off, np.int32, n + 1)
        off += 4 * (n + 1)
        nulls, off = _decode_nulls(buf, off, n)
        return WireBlock("ARRAY", nulls=nulls, children=[elements],
                         offsets=offsets), off
    if name == "MAP":
        keys, off = _decode_block(buf, off)
        vals, off = _decode_block(buf, off)
        (ht_len,) = struct.unpack_from("<i", buf, off)
        off += 4
        if ht_len >= 0:          # reader-side lookup index — not needed
            off += 4 * ht_len
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        offsets = _view(buf, off, np.int32, n + 1)
        off += 4 * (n + 1)
        nulls, off = _decode_nulls(buf, off, n)
        return WireBlock("MAP", nulls=nulls, children=[keys, vals],
                         offsets=offsets), off
    if name == "ROW":
        (nf,) = struct.unpack_from("<i", buf, off)
        off += 4
        fields = []
        for _ in range(nf):
            f, off = _decode_block(buf, off)
            fields.append(f)
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        offsets = _view(buf, off, np.int32, n + 1)
        off += 4 * (n + 1)
        nulls, off = _decode_nulls(buf, off, n)
        return WireBlock("ROW", nulls=nulls, children=fields,
                         offsets=offsets), off
    if name == "RLE":
        (count,) = struct.unpack_from("<i", buf, off)
        off += 4
        inner, off = _decode_block(buf, off)
        return WireBlock("RLE", rle_value=inner, count=count), off
    if name == "DICTIONARY":
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        dictionary, off = _decode_block(buf, off)
        ids = _view(buf, off, np.int32, n)
        off += 4 * n
        off += 24  # instance id
        return WireBlock("DICTIONARY", ids, None, dictionary=dictionary), off
    raise ValueError(f"unsupported encoding {name}")


# ---------------------------------------------------------------------------
# page level
# ---------------------------------------------------------------------------

def _checksum_tail(crc: int, markers: int, position_count: int,
                   uncompressed: int) -> int:
    """Chain the header fields onto a payload CRC (Java updateCrc order:
    markers byte, positionCount, uncompressedSize, little-endian)."""
    tail = bytes([markers & 0xFF]) + struct.pack("<i", position_count) \
        + struct.pack("<i", uncompressed)
    return zlib.crc32(tail, crc)


def _checksum(payload, markers: int, position_count: int,
              uncompressed: int) -> int:
    # the native slice-by-8 CRC (csrc/page_codec.cc) or zlib's: both
    # compute the same reflected-poly value java.util.zip.CRC32 does
    from presto_tpu_torch import native
    crc = native.crc32(payload)
    if crc is None:
        crc = zlib.crc32(payload)
    return _checksum_tail(crc, markers, position_count, uncompressed)


def encode_page_buffer(blocks: List[WireBlock],
                       checksummed: bool = True,
                       compression: Optional[str] = None) -> PageBuffer:
    """Encode a page into ONE pre-sized allocation (see `PageBuffer`)."""
    if not blocks:
        raise ValueError("page needs at least one block")
    position_count = blocks[0].position_count
    w = _PageWriter()
    w.put(struct.pack("<i", len(blocks)))
    block_offsets = []
    for b in blocks:
        block_offsets.append(w.size)
        _encode_block(w, b)
    uncompressed = w.size
    markers = CHECKSUMMED if checksummed else 0
    buf = None
    if compression in ("zlib", "gzip", "lz4") and uncompressed > 256:
        raw = bytearray(uncompressed)
        w.write_into(memoryview(raw), 0)
        comp = _compress(raw, compression)
        if comp is not None and len(comp) < uncompressed:
            buf = bytearray(21 + len(comp))
            buf[21:] = comp
            # codec id in the marker byte's spare bits (above
            # COMPRESSED/ENCRYPTED/CHECKSUMMED) so the consumer decodes
            # deterministically instead of sniffing magic bytes — an
            # LZ4 block can begin with zlib's 0x78
            markers |= COMPRESSED | _CODEC_BITS[compression]
        else:
            buf = bytearray(21 + uncompressed)
            buf[21:] = raw             # keep raw when incompressible
    elif compression not in (None, "none", "zlib", "gzip", "lz4"):
        raise ValueError(f"unsupported exchange compression "
                         f"{compression!r}")
    if buf is None:
        buf = bytearray(21 + uncompressed)
        w.write_into(memoryview(buf), 21)
    # checksum covers the payload AS TRANSMITTED
    # (PagesSerdeUtil.computeSerializedPageChecksum)
    checksum = 0
    if checksummed:
        checksum = _checksum(memoryview(buf)[21:], markers,
                             position_count, uncompressed)
    _HEADER.pack_into(buf, 0, position_count, markers, uncompressed,
                      len(buf) - 21, checksum)
    return PageBuffer(buf, tuple(block_offsets), position_count)


def encode_serialized_page(blocks: List[WireBlock],
                           checksummed: bool = True,
                           compression: Optional[str] = None) -> bytes:
    return encode_page_buffer(blocks, checksummed,
                              compression).to_bytes()


def _compress(payload, codec: str):
    """Compress per the session codec (CompressionCodec.java:16 — the
    reference offers GZIP/LZ4/ZSTD next to NONE). LZ4 block format runs
    in the host codec library (csrc/page_codec.cc, built by
    native.codec()); without it the lz4 codec raises, never falls back."""
    if codec == "zlib":
        return zlib.compress(bytes(payload), 6)
    if codec == "gzip":
        co = zlib.compressobj(6, zlib.DEFLATED, 31)   # gzip wrapper
        return co.compress(bytes(payload)) + co.flush()
    # lz4 block
    from presto_tpu_torch import native
    out = native.lz4_compress(payload)
    if out is None:
        raise ValueError(
            "lz4 codec requires the native page codec library")
    return out


def _decompress(payload, uncompressed: int,
                codec: Optional[str] = None) -> bytes:
    """Deterministic decode when the frame's marker bits name the codec;
    magic-byte sniffing (zlib/gzip by magic, LZ4 block fallback) only
    for unmarked legacy frames — every path is validated against the
    frame's declared uncompressed size afterwards."""
    if codec == "zlib":
        return zlib.decompress(payload)
    if codec == "gzip":
        return zlib.decompress(payload, 31)
    if codec == "lz4":
        from presto_tpu_torch import native
        out = native.lz4_decompress(payload, uncompressed)
        if out is None:
            raise ValueError("lz4 frame but no native codec library")
        return out
    if len(payload) >= 2 and payload[0] == 0x78:
        try:
            return zlib.decompress(payload)
        except zlib.error:
            pass                       # an LZ4 block may start 0x78
    if len(payload) >= 2 and payload[0] == 0x1F and payload[1] == 0x8B:
        try:
            return zlib.decompress(payload, 31)
        except zlib.error:
            pass                   # an LZ4 block may start 0x1F 0x8B too
    from presto_tpu_torch import native
    out = native.lz4_decompress(payload, uncompressed)
    if out is None:
        raise ValueError("cannot decompress page (unknown codec or "
                         "native library unavailable)")
    return out


def decode_serialized_page(data, offset: int = 0
                           ) -> Tuple[List[WireBlock], int, int]:
    """Returns (blocks, position_count, next_offset). Decoded lanes are
    READ-ONLY views aliasing `data` (zero-copy; writing raises) — the
    views' .base keeps the frame buffer alive with the page."""
    position_count, markers, uncompressed, size, checksum = \
        _HEADER.unpack_from(data, offset)
    off = offset + 21
    mv = memoryview(data)
    if not mv.readonly:
        mv = mv.toreadonly()
    payload = mv[off:off + size]
    if markers & ENCRYPTED:
        raise NotImplementedError("encrypted pages")
    if markers & CHECKSUMMED:
        want = _checksum(payload, markers, position_count, uncompressed)
        if want != checksum:
            raise ValueError(f"page checksum mismatch: {want} != {checksum}")
    if markers & COMPRESSED:
        codec = _CODEC_BY_ID.get((markers >> _CODEC_SHIFT) & 0x3)
        payload = memoryview(_decompress(payload, uncompressed, codec))
        if len(payload) != uncompressed:
            raise ValueError(
                f"decompressed size {len(payload)} != declared "
                f"{uncompressed}")
    (nblocks,) = struct.unpack_from("<i", payload, 0)
    p = 4
    blocks = []
    for _ in range(nblocks):
        b, p = _decode_block(payload, p)
        blocks.append(b)
    return blocks, position_count, off + size


# ---------------------------------------------------------------------------
# engine Page <-> wire blocks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    """A tensor lane on the host."""
    return t.cpu().numpy()


def _flat_to_wire(t, vals: np.ndarray, nulls: np.ndarray,
                  dictionary) -> WireBlock:
    if t.is_string and dictionary is not None:
        words = np.array(
            [w.encode() for w in dictionary.words] or [b""],
            dtype=object)
        dict_block = WireBlock("VARIABLE_WIDTH", words, None)
        ids = np.where(nulls, 0, vals).astype(np.int32)
        # a null string position is a null slot appended to the
        # dictionary
        if nulls.any():
            null_slot = len(words)
            words2 = np.append(words, None)
            dict_block = WireBlock(
                "VARIABLE_WIDTH", words2,
                np.arange(len(words2)) == null_slot)
            ids = np.where(nulls, null_slot, ids).astype(np.int32)
        return WireBlock("DICTIONARY", ids, None, dictionary=dict_block)
    if t.dtype == np.bool_:
        return WireBlock("BYTE_ARRAY", vals.astype(np.uint8),
                         nulls if nulls.any() else None)
    if t.dtype == np.int32:
        return WireBlock("INT_ARRAY", vals.astype(np.int32),
                         nulls if nulls.any() else None)
    if t.dtype == np.int64:
        return WireBlock("LONG_ARRAY", vals.astype(np.int64),
                         nulls if nulls.any() else None)
    if t.dtype == np.float64:
        return WireBlock("LONG_ARRAY", vals.view(np.int64),
                         nulls if nulls.any() else None)
    if t.dtype == np.float32:
        return WireBlock("INT_ARRAY", vals.view(np.int32),
                         nulls if nulls.any() else None)
    raise NotImplementedError(f"wire type {t}")


def _any_to_wire(col, idx: np.ndarray) -> WireBlock:
    """Column/NestedColumn rows at absolute positions `idx` -> WireBlock."""
    from presto_tpu_torch.data.column import NestedColumn
    if isinstance(col, NestedColumn):
        return _nested_to_wire(col, idx)
    v, nl = col.to_numpy()
    return _flat_to_wire(col.type, v[idx], nl[idx].copy(),
                         col.dictionary)


def _nested_to_wire(col, idx: np.ndarray) -> WireBlock:
    """NestedColumn rows at `idx` -> ARRAY/MAP/ROW WireBlock with
    contiguous rebased offsets (the reference encodings' region form)."""
    starts = _np(col.starts)[idx]
    lengths = _np(col.lengths)[idx]
    nulls = _np(col.nulls)[idx].copy()
    t = col.type
    if t.name == "row":
        # field entries exist only for non-null rows; offsets advance
        # by 1 per non-null row (createRowBlockInternal semantics)
        keep = ~nulls
        fidx = starts[keep]
        children = [_any_to_wire(ch, fidx) for ch in col.children]
        offsets = np.zeros(len(idx) + 1, np.int32)
        offsets[1:] = np.cumsum(keep)
        return WireBlock("ROW", nulls=nulls if nulls.any() else None,
                         children=children, offsets=offsets)
    lens = np.where(nulls, 0, lengths).astype(np.int64)
    eidx = (np.concatenate(
        [np.arange(s, s + ln) for s, ln in zip(starts, lens)])
        if len(idx) else np.zeros(0, np.int64)).astype(np.int64)
    offsets = np.zeros(len(idx) + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    children = [_any_to_wire(ch, eidx) for ch in col.children]
    return WireBlock("ARRAY" if t.name == "array" else "MAP",
                     nulls=nulls if nulls.any() else None,
                     children=children, offsets=offsets)


def page_to_wire_blocks(page) -> List[WireBlock]:
    """Host-side conversion of a port Page to wire blocks (one device to
    host copy per lane). Strings become DICTIONARY over VARIABLE_WIDTH;
    DECIMAL<=18 travels as LONG_ARRAY (short decimal), DECIMAL(p>18) as
    INT128_ARRAY (exact; an average form pre-divides, so the wire carries
    its final value); ARRAY/MAP/ROW nest recursively."""
    from presto_tpu_torch.data.column import (
        DEC_CTX, Decimal128Column, NestedColumn,
    )

    n = int(page.num_rows)
    out: List[WireBlock] = []
    for c in page.columns:
        if isinstance(c, NestedColumn):
            out.append(_nested_to_wire(c, np.arange(n)))
            continue
        if isinstance(c, Decimal128Column):
            lanes = np.zeros((n, 2), dtype=np.int64)
            nulls = _np(c.nulls)[:n].copy()
            scale = c.type.scale
            for i in range(n):
                if nulls[i]:
                    continue
                if c.count is None:
                    unscaled = c.unscaled_at(i)
                else:
                    v = c.value_at(i)   # avg pre-divides host-side
                    unscaled = (int(DEC_CTX.scaleb(v, scale)) if scale
                                else int(v))
                lanes[i, 0] = (unscaled & ((1 << 64) - 1)) - (
                    1 << 64 if unscaled & (1 << 63) else 0)
                lanes[i, 1] = unscaled >> 64
            out.append(WireBlock("INT128_ARRAY", lanes,
                                 nulls if nulls.any() else None))
            continue
        vals, nulls = c.to_numpy(n)
        out.append(_flat_to_wire(c.type, vals, nulls.copy(),
                                 c.dictionary))
    return out


def _wire_to_column(b: WireBlock, t, position_count: int, capacity: int,
                    device):
    """One wire block -> port Column/Decimal128Column/NestedColumn of type
    t on `device` (presto_tpu/protocol/serde.py:772)."""
    from presto_tpu_torch.data.column import (
        Column, Decimal128Column, NestedColumn, StringDict, bucket_capacity,
    )

    b = _materialize_rle(b)
    if b.encoding in ("ARRAY", "MAP", "ROW"):
        n = position_count
        offs = np.asarray(b.offsets, np.int32)
        nulls = (b.nulls if b.nulls is not None
                 else np.zeros(n, dtype=bool))
        starts = offs[:-1].copy()
        lengths = np.diff(offs).astype(np.int32)
        if b.encoding == "ROW":
            lengths = np.where(nulls[:n], 0, 1).astype(np.int32)
        child_types = (
            (t.element,) if t.name == "array" else
            (t.key, t.value) if t.name == "map" else t.field_types)
        n_child = int(offs[-1]) if len(offs) else 0
        ccap = bucket_capacity(max(n_child, 1))
        children = tuple(
            _wire_to_column(cb, ct, n_child, ccap, device)
            for cb, ct in zip(b.children, child_types))
        pad = capacity - n
        return NestedColumn._of(
            np.pad(starts, (0, pad)).astype(np.int32),
            np.pad(lengths, (0, pad)).astype(np.int32),
            np.pad(nulls[:n], (0, pad), constant_values=True),
            children, t, device)
    if b.encoding == "INT128_ARRAY" and getattr(t, "uses_int128", False):
        n = position_count
        nulls = (b.nulls if b.nulls is not None
                 else np.zeros(n, dtype=bool))
        ints = []
        for i in range(n):
            if bool(nulls[i]):
                ints.append(None)
                continue
            low = int(b.values[i, 0]) & ((1 << 64) - 1)
            ints.append((int(b.values[i, 1]) << 64) | low)
        return Decimal128Column.from_unscaled_ints(
            ints, t, capacity=capacity, device=device)
    if t.is_string:
        words, codes, nulls = _block_to_strings(b, position_count)
        return Column.from_numpy(codes, t, nulls=nulls,
                                 dictionary=StringDict(words),
                                 capacity=capacity, device=device)
    vals = b.values
    nulls = b.nulls if b.nulls is not None else \
        np.zeros(position_count, dtype=bool)
    if t.dtype == np.float64:
        vals = vals.view(np.float64)
    elif t.dtype == np.float32:
        vals = vals.astype(np.int32).view(np.float32)
    elif t.dtype == np.bool_:
        vals = vals.astype(bool)
    else:
        vals = vals.astype(t.dtype)
    vals = np.where(nulls, t.dtype.type(t.null_sentinel()), vals) \
        if nulls.any() else vals
    return Column.from_numpy(vals, t, nulls=nulls, capacity=capacity,
                             device=device)


def wire_blocks_to_page(blocks: List[WireBlock], types, position_count: int,
                        capacity: Optional[int] = None, device=None):
    """Wire blocks -> port Page on `device` (None means the card).
    `types` are the port's SQL types."""
    from presto_tpu_torch.data.column import Page, bucket_capacity

    cap = capacity or bucket_capacity(max(position_count, 1))
    cols = [_wire_to_column(b, t, position_count, cap, device)
            for b, t in zip(blocks, types)]
    return Page.from_columns(cols, position_count, device=device)


def _materialize_rle(b: WireBlock) -> WireBlock:
    if b.encoding != "RLE":
        return b
    v = b.rle_value
    n = b.count
    if v.encoding == "VARIABLE_WIDTH":
        vals = np.empty(n, dtype=object)
        vals[:] = [v.values[0]] * n
        nulls = np.full(n, bool(v.nulls[0]) if v.nulls is not None
                        else False)
        return WireBlock("VARIABLE_WIDTH", vals, nulls)
    vals = np.repeat(v.values[:1], n, axis=0)
    nulls = np.full(n, bool(v.nulls[0]) if v.nulls is not None else False)
    return WireBlock(v.encoding, vals, nulls)


def _block_to_strings(b: WireBlock, n: int):
    """Decode a string block to (sorted words, codes, nulls): the
    engine's sorted-dictionary layout."""
    if b.encoding == "DICTIONARY":
        d = b.dictionary
        raw = [None if (d.nulls is not None and d.nulls[i]) else
               (d.values[i] or b"").decode() for i in range(len(d.values))]
        ids = b.values
        strings = [raw[i] for i in ids]
    elif b.encoding == "VARIABLE_WIDTH":
        strings = [None if v is None else v.decode() for v in b.values]
    else:
        raise NotImplementedError(f"string block {b.encoding}")
    nulls = np.array([s is None for s in strings], dtype=bool)
    filled = ["" if s is None else s for s in strings]
    uniq, codes = np.unique(np.asarray(filled, dtype=object).astype(str),
                            return_inverse=True)
    return [str(u) for u in uniq], codes.astype(np.int32), nulls
