"""Image layer: the pixel model, PNG encode and decode, depth maps, image
arithmetic and the background saver.

Counterpart of ``ndt_tpu/image_io.py`` (image.{h,c}).  The reference keeps
linear doubles in [0, 1] and "quadratic" bytes, 255 * sqrt(linear)
(image.h:16, 34-43); rendering happens in linear float and files hold the
bytes, so they compare directly with the C binary's.

PNG (8-bit RGB) is encoded and decoded here with ``zlib`` and ``struct``:
no image library is needed for it.  JPEG needs Pillow and raises without
it; no other format is written in its place.  The background save threads
(image.c:741-803) are a small thread pool with a drain() barrier, so the
device renders frame N+1 while the host encodes frame N (zlib releases the
GIL).
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ndt_tpu_torch.utils import telemetry

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def linear_to_bytes(img: np.ndarray) -> np.ndarray:
    """pixel_d2c (image.h:34-38): clamp to [0, 1], sqrt, scale to 0..255."""
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255.0).astype(np.uint8)


def bytes_to_linear(img: np.ndarray) -> np.ndarray:
    """pixel_c2d (image.h:40-43): (byte/255)^2."""
    return (img.astype(np.float64) / 255.0) ** 2


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """dbl_image_normalize (image.c:1025-1066): min/max scale the recorded
    1/dist values into [0, 1] (zeros -- no hit -- take part as 0)."""
    lo = float(depth.min())
    hi = float(depth.max())
    if hi - lo <= 0:
        return np.zeros_like(depth)
    return (depth - lo) / (hi - lo)


# -- PNG ---------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB, non-interlaced PNG of ``rgb`` ([H, W, 3] uint8):
    every scanline with filter type 0, one zlib IDAT chunk, CRCs."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3] bytes, not {rgb.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_row(ftype, line, prev, bpp):
    """One scanline of PNG filter ``ftype`` undone (int32 arrays)."""
    if ftype == 0:
        return line
    if ftype == 1:                      # Sub: a running sum per channel
        return (np.cumsum(line.reshape(-1, bpp), axis=0).ravel()) & 255
    if ftype == 2:                      # Up
        return (line + prev) & 255
    cur = np.zeros_like(line)
    for x in range(len(line)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ftype == 3:                  # Average
            pred = (a + b) >> 1
        else:                           # 4: Paeth
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (line[x] + pred) & 255
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB or RGBA non-interlaced PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h = int.from_bytes(hdr[0:4], "big"), int.from_bytes(hdr[4:8], "big")
    depth, ctype, interlace = hdr[8], hdr[9], hdr[12]
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        prev = out[y] = _unfilter_row(raw[y, 0], raw[y, 1:].astype(np.int32),
                                      prev, bpp)
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of the PNG file ``path`` (decode_png)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# -- files -------------------------------------------------------------------


def _format(path: str, fmt: Optional[str]) -> str:
    fmt = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    if fmt in ("jpg", "jpeg"):
        return "jpeg"
    if fmt != "png":
        raise ValueError(f"{path}: cannot write format {fmt!r} (png, jpeg)")
    return fmt


def save_image(path: str, img_linear: np.ndarray, fmt: Optional[str] = None):
    """Encode a [H, W, 3] linear float image as PNG (the port's encoder) or
    JPEG (Pillow; without it this raises), chosen by ``fmt`` or the file's
    extension."""
    fmt = _format(path, fmt)
    data = linear_to_bytes(np.asarray(img_linear))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if fmt == "jpeg":
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path}: writing JPEG needs Pillow (the "
                              "'PIL' package), which is not installed") from e
        Image.fromarray(data).save(path, format="JPEG")
        return
    with open(path, "wb") as f:
        f.write(encode_png(data))


def save_depth(path: str, depth: np.ndarray, fmt: Optional[str] = None):
    """Depth maps are written normalized, one channel replicated
    (ndt.c:1012-1018, image.c:1025)."""
    norm = normalize_depth(np.asarray(depth))
    save_image(path, np.repeat(norm[..., None], 3, axis=-1), fmt)


def load_image(path: str) -> np.ndarray:
    """An image file as linear floats (image.c:271-343): PNG through the
    port's decoder, anything else through Pillow (without it this
    raises)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return bytes_to_linear(read_png_rgb(path))
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading a non-PNG image needs Pillow "
                          "(the 'PIL' package), which is not installed") from e
    with Image.open(path) as im:
        return bytes_to_linear(np.asarray(im.convert("RGB")))


# -- image arithmetic (image.h:105-116) --------------------------------------


def image_add(a, b):
    return a + b


def image_subtract(a, b):
    return a - b


def image_scale(a, s):
    return a * s


def image_avg(images):
    return np.mean(np.stack(images), axis=0)


def gaussian_kernel(size: int, std_dev: float) -> np.ndarray:
    """image_calc_gaussian (image.c:886-905)."""
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs[None, :] ** 2 + xs[:, None] ** 2) / (2 * std_dev ** 2))
    return g / g.sum()


def convolve(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """image_convolve (image.c:808-884): zero-padded 2-D convolution per
    channel."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw), (0, 0)))
    out = np.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            out += kernel[dy, dx] * padded[dy:dy + img.shape[0],
                                           dx:dx + img.shape[1]]
    return out


def image_downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """image_scale by an integer factor, box averaging (image.c:907-...)."""
    h, w = img.shape[0] // factor * factor, img.shape[1] // factor * factor
    v = img[:h, :w].reshape(h // factor, factor, w // factor, factor, -1)
    return v.mean(axis=(1, 3))


class AsyncSaver:
    """Background image saver (image_save_bg, image.c:741-803): encodes go
    to a worker pool and drain() waits for them (ndt.c:2061-2066 spins on
    image_active_saves()).  If the pool refuses a task the save runs
    synchronously, as the C does when pthread_create fails
    (image.c:790-794)."""

    def __init__(self, workers: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        self._pending = []
        self._lock = threading.Lock()

    def active_saves(self) -> int:
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            return len(self._pending)

    @telemetry.traced("ndt.save")
    def save(self, path, img_linear, fmt=None, saver=save_image):
        img_copy = np.array(img_linear, copy=True)
        try:
            fut = self._pool.submit(saver, path, img_copy, fmt)
        except RuntimeError:
            saver(path, img_copy, fmt)
            return
        with self._lock:
            self._pending.append(fut)

    def drain(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def shutdown(self):
        self.drain()
        self._pool.shutdown()
