"""Training-image loading (reference: image_loader.mm + stb_image).

The reference decodes every ground-truth view to an RGBA8 Metal texture
upfront (image_loader.mm:44-99).  Here images decode to float32 [H, W, 3]
numpy arrays in [0, 1]; the trainer ships them to device per step (or they can
be pre-committed with jax.device_put).

8-bit non-interlaced PNG (what tools/make_dataset and the renderers write) is
decoded and encoded here with zlib and numpy alone.  Other formats (JPEG,
16-bit or interlaced PNG) go through Pillow, an optional dependency."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each 8-bit PNG color type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG variant this module does not decode (left to Pillow)."""


def _png_chunks(data: bytes):
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None, Sub, Up, Average, Paeth).

    Every filter predicts a byte from its left, up and up-left neighbours
    only, so all pixels on one anti-diagonal (row + column = const) are
    independent: the reconstruction sweeps the H + W - 1 diagonals, each
    vectorized over its pixels and channels."""
    rows = raw.reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    width = stride // bpp
    filt = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8).reshape(height, stride)
    rec = np.zeros((height + 1, width + 1, bpp), np.int32)   # zero border
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        x = d - r
        a = rec[r + 1, x]          # left
        b = rec[r, x + 1]          # up
        c = rec[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(height, stride)


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to uint8 [H, W, C] (C = 1, 2, 3
    or 4; palette images come back as RGB).  Raises UnsupportedPNG for
    other bit depths and for interlaced files."""
    header = None
    palette = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise UnsupportedPNG(
            f"PNG bit depth {depth}, color type {ctype}, interlace "
            f"{interlace}: only 8-bit non-interlaced PNG is decoded natively"
        )
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * ch + 1):
        raise ValueError("PNG image data has the wrong size")
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        img = palette[img[..., 0]]
    return img


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """Encode uint8 [H, W, C] (C = 1, 2, 3 or 4) as an 8-bit PNG."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * ch)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    return (
        _PNG_SIG
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def _decode_with_pillow(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {os.path.basename(path)} needs Pillow (PIL), which "
            "is not installed; only 8-bit non-interlaced PNG is read without it"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear (triangle) resampling weights whose support
    widens with the downscale factor, like Pillow's BILINEAR resize."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (np.arange(n_out) + 0.5) * scale
    src = np.arange(n_in) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(src[None, :] - centers[:, None]) / support)
    return w / w.sum(axis=1, keepdims=True)


def resize(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of float [H, W, C] to (W, H) = ``size``."""
    w_out, h_out = size
    ry = _resample_matrix(image.shape[0], h_out)
    rx = _resample_matrix(image.shape[1], w_out)
    return np.einsum(
        "yh,hwc,xw->yxc", ry, image, rx, optimize=True
    ).astype(np.float32)


def load_image(path: str, target_size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode an image to float32 [H, W, 3] in [0, 1]; optional (W, H) resize."""
    with open(path, "rb") as f:
        data = f.read()
    arr = None
    if data.startswith(_PNG_SIG):
        try:
            arr = decode_png(data)
        except UnsupportedPNG:
            pass
    if arr is None:
        arr = _decode_with_pillow(path)
    if arr.shape[-1] < 3:                       # gray (+ alpha) -> RGB
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    img = arr[..., :3].astype(np.float32) / 255.0
    if target_size is not None and (img.shape[1], img.shape[0]) != tuple(target_size):
        img = np.clip(resize(img, target_size), 0.0, 1.0)
    return img


def find_image(images_dir: str, name: str) -> str | None:
    """Resolve a COLMAP image name against the images directory, tolerating
    extension mismatches."""
    direct = os.path.join(images_dir, name)
    if os.path.exists(direct):
        return direct
    stem = os.path.splitext(name)[0]
    for ext in (".jpg", ".JPG", ".jpeg", ".png", ".PNG"):
        p = os.path.join(images_dir, stem + ext)
        if os.path.exists(p):
            return p
    return None


def save_ppm(path: str, image: np.ndarray) -> None:
    """Write a binary P6 PPM like the reference's render snapshots
    (saveTextureToPPM, mtl_engine.mm:19-63)."""
    arr = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr[:, :, :3].tobytes())


def save_png(path: str, image: np.ndarray) -> None:
    """Write float [H, W, C] in [0, 1] as an 8-bit PNG."""
    arr = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
