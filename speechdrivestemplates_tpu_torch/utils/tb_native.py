"""TensorBoard event files in TensorBoard's own format, numpy and the standard
library only.

The port's copy of the JAX package's ``utils/tb_native.py``: TFRecord framing
(``uint64 length | masked crc32c(length) | payload | masked crc32c(payload)``,
Castagnoli CRC with TensorFlow's rotate-and-add mask) around hand-encoded
``Event`` / ``Summary`` protobufs. ``NativeTBWriter`` writes
``events.out.tfevents.<time>.<host>.<pid>.0`` into a run's directory: scalars,
PNG image summaries (``add_image``; ``add_figure`` rasterizes a matplotlib
figure with Agg) and videos as animated-GIF image summaries (``add_video``;
TensorBoard's image plugin plays them), byte for byte the JAX writer's
payloads. It is the port's only writer: the JAX trainer prefers
``torch.utils.tensorboard`` where it imports, which needs the ``tensorboard``
package the card's host is not known to have. Writes are serialized by a
lock, since the video queue (``utils/video.py``) writes from its own thread.
``read_events`` reads a file back (tests, the chip smoke run).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _png_encode(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _quantize_676(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(..., 3) uint8 -> (palette indices, (256, 3) palette): the fixed 6x7x6
    RGB cube (252 entries), no per-video palette."""
    levels_r = np.round(np.linspace(0, 255, 6)).astype(np.uint8)
    levels_g = np.round(np.linspace(0, 255, 7)).astype(np.uint8)
    levels_b = np.round(np.linspace(0, 255, 6)).astype(np.uint8)
    palette = np.zeros((256, 3), np.uint8)
    palette[:252] = np.stack(np.meshgrid(levels_r, levels_g, levels_b, indexing="ij"),
                             axis=-1).reshape(-1, 3)
    qr = np.round(frames[..., 0].astype(np.float32) * (5 / 255)).astype(np.int32)
    qg = np.round(frames[..., 1].astype(np.float32) * (6 / 255)).astype(np.int32)
    qb = np.round(frames[..., 2].astype(np.float32) * (5 / 255)).astype(np.int32)
    return (qr * 42 + qg * 6 + qb).astype(np.uint8), palette


def _gif_lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's LZW over a uint8 index array (row-major), in 255-byte sub-blocks.
    The JAX encoder's codes exactly (the table resets when it reaches 4096
    codes), its strings kept as (prefix code << 8 | byte) ints, which runs
    about twice as fast as a table of byte strings."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc, nbits, width = clear, min_code_size + 1, min_code_size + 1
    table: dict = {}
    get = table.get
    next_code, cur = end + 1, -1
    for ch in indices.tobytes():
        if cur < 0:
            cur = ch
            continue
        code = get((cur << 8) | ch)
        if code is not None:
            cur = code
            continue
        acc |= cur << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        table[(cur << 8) | ch] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        elif next_code >= 4096:
            acc |= clear << nbits
            nbits += width
            table.clear()
            next_code, width = end + 1, min_code_size + 1
        cur = ch
    for code in ((cur, end) if cur >= 0 else (end,)):
        acc |= code << nbits
        nbits += width
    while nbits > 0:
        out.append(acc & 0xFF)
        acc >>= 8
        nbits -= 8
    blocks = bytearray([min_code_size])
    for i in range(0, len(out), 255):
        chunk = out[i: i + 255]
        blocks.append(len(chunk))
        blocks += chunk
    blocks.append(0)
    return bytes(blocks)


def gif_encode(frames: np.ndarray, fps: int = 4) -> bytes:
    """(T, H, W, 3) uint8 -> looping animated GIF89a bytes (the fixed-cube
    palette, one LZW image a frame)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, _ = frames.shape
    indexed, palette = _quantize_676(frames)
    delay_cs = max(2, round(100 / max(1, fps)))  # GIF delay in 10 ms units
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global colour table of 256
    out += palette.tobytes()
    out += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for i in range(t):
        out += b"\x21\xF9\x04" + struct.pack("<BHB", 0, delay_cs, 0) + b"\x00"
        out += b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += _gif_lzw(indexed[i])
    out += b"\x3B"
    return bytes(out)


def gif_decode(data: bytes) -> np.ndarray:
    """The frames of a GIF that ``gif_encode`` wrote -> (T, H, W, 3) uint8
    (global palette, full-size frames)."""
    if data[:6] not in (b"GIF89a", b"GIF87a"):
        raise ValueError("not a GIF")
    _, _, packed, _, _ = struct.unpack("<HHBBB", data[6:13])
    if not packed & 0x80:
        raise ValueError("no global colour table")
    gct = 2 << (packed & 0x07)
    palette = np.frombuffer(data[13: 13 + gct * 3], np.uint8).reshape(-1, 3)
    pos, frames = 13 + gct * 3, []
    while pos < len(data) and data[pos] != 0x3B:
        if data[pos] == 0x21:  # an extension: skip its sub-blocks
            pos += 2
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
            continue
        if data[pos] != 0x2C:
            raise ValueError(f"unexpected GIF block 0x{data[pos]:02x}")
        fw, fh, fpacked = struct.unpack("<HHB", data[pos + 5: pos + 10])
        if fpacked & 0x80:
            raise ValueError("local colour tables are not read")
        min_code_size, pos = data[pos + 10], pos + 11
        lzw = bytearray()
        while data[pos]:
            lzw += data[pos + 1: pos + 1 + data[pos]]
            pos += 1 + data[pos]
        pos += 1
        clear = 1 << min_code_size
        width = min_code_size + 1
        table = [bytes([i]) for i in range(clear)] + [b"", b""]
        acc = nbits = 0
        out, prev = bytearray(), None
        for byte in lzw:
            acc |= byte << nbits
            nbits += 8
            while nbits >= width:
                code = acc & ((1 << width) - 1)
                acc >>= width
                nbits -= width
                if code == clear:
                    table = [bytes([i]) for i in range(clear)] + [b"", b""]
                    width, prev = min_code_size + 1, None
                    continue
                if code == clear + 1:
                    acc = nbits = 0
                    break
                if code < len(table):
                    entry = table[code]
                    if prev is not None:
                        table.append(prev + entry[:1])
                else:
                    entry = prev + prev[:1]
                    table.append(entry)
                out += entry
                prev = entry
                # the encoder widens its codes after it assigns code 2^width;
                # this table (with the clear and end slots) reaches 2^width then
                if len(table) >= (1 << width) and width < 12:
                    width += 1
        frames.append(palette[np.frombuffer(bytes(out[: fw * fh]), np.uint8).reshape(fh, fw)])
    return np.stack(frames)


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _f_double(1, time.time())
    if step is not None:
        out += _f_varint(2, int(step))
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, val)  # Summary.value (repeated field 1)


def _encoded_image_summary(tag: str, h: int, w: int, encoded: bytes) -> bytes:
    img = _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, 3) + _f_bytes(4, encoded)
    return _f_bytes(1, _f_bytes(1, tag.encode()) + _f_bytes(4, img))


def _image_summary(tag: str, rgb: np.ndarray) -> bytes:
    h, w, _ = rgb.shape
    return _encoded_image_summary(tag, h, w, _png_encode(rgb))


def _to_uint8(x: np.ndarray) -> np.ndarray:
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x if x.dtype == np.uint8 else (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


class NativeTBWriter:
    """``add_scalar``, ``add_image``, ``add_figure``, ``add_video``, ``flush``
    and ``close`` of ``SummaryWriter``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self.path = os.path.join(log_dir, name)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))
        self.flush()

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        record = (header + struct.pack("<I", masked_crc(header))
                  + payload + struct.pack("<I", masked_crc(payload)))
        with self._lock:
            self._f.write(record)

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None) -> None:
        self._write(_event(step=global_step, summary=_scalar_summary(tag, float(value))))

    def add_image(self, tag: str, img, global_step: Optional[int] = None,
                  dataformats: str = "CHW") -> None:
        """A PNG image summary of (C, H, W) or (H, W, C) uint8, or float in [0, 1]."""
        img = np.asarray(img)
        if dataformats == "CHW" or (img.ndim == 3 and img.shape[0] in (1, 3)
                                    and dataformats != "HWC"):
            img = np.transpose(img, (1, 2, 0))
        self._write(_event(step=global_step, summary=_image_summary(tag, _to_uint8(img))))

    def add_figure(self, tag: str, figure, global_step: Optional[int] = None) -> None:
        """A matplotlib figure, drawn by its canvas (Agg), as a PNG image summary."""
        figure.canvas.draw()
        rgb = np.asarray(figure.canvas.buffer_rgba())[..., :3]
        self._write(_event(step=global_step, summary=_image_summary(tag, rgb)))

    def add_video(self, tag: str, vid_tensor, global_step: Optional[int] = None,
                  fps: int = 4) -> None:
        """(1, T, C, H, W), float in [0, 1] or uint8 -> an animated-GIF image
        summary of its first video."""
        v = np.asarray(vid_tensor)
        if v.ndim != 5:
            raise ValueError(f"add_video takes (B, T, C, H, W), got {v.shape}")
        frames = _to_uint8(np.transpose(v[0], (0, 2, 3, 1)))
        h, w = frames.shape[1:3]
        self._write(_event(step=global_step, summary=_encoded_image_summary(
            tag, h, w, gif_encode(frames, fps=fps))))

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    pos = 0
    while pos < len(data):
        k, pos = _read_varint(data, pos)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, pos = _read_varint(data, pos)
            yield field, wire, v
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            yield field, wire, data[pos: pos + n]
            pos += n
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            yield field, wire, data[pos: pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wire}")


def read_events(path: str) -> list:
    """An event file's summaries, CRC-checked: ``{step, tag, value}`` for a
    scalar, ``{step, tag, png}`` for an image (the encoded bytes: PNG, or GIF
    for a video)."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos: pos + 8]
        (length,) = struct.unpack("<Q", header)
        payload = data[pos + 12: pos + 12 + length]
        if (struct.unpack("<I", data[pos + 8: pos + 12])[0] != masked_crc(header)
                or struct.unpack("<I", data[pos + 12 + length: pos + 16 + length])[0]
                != masked_crc(payload)):
            raise ValueError(f"{path}: corrupt record at byte {pos}")
        pos += 16 + length
        step, summary = 0, None
        for field, wire, v in _fields(payload):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                summary = v
        for field, wire, val in _fields(summary or b""):
            if field != 1 or wire != 2:
                continue
            tag, scalar, png = None, None, None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif f2 == 2 and w2 == 5:
                    (scalar,) = struct.unpack("<f", v2)
                elif f2 == 4 and w2 == 2:
                    png = next((v3 for f3, w3, v3 in _fields(v2) if f3 == 4 and w3 == 2), None)
            if scalar is not None:
                out.append({"step": step, "tag": tag, "value": scalar})
            elif png is not None:
                out.append({"step": step, "tag": tag, "png": png})
    return out
