"""Grayscale image IO (counterpart of multi_modal_image_fusion_tpu
data/io.py) with its own BMP and PNG codec.

The reference reads with `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` and
writes with `cv2.imwrite`. Machines that run the port need neither cv2 nor
PIL: BMP (8-bit paletted, 24-bit, 32-bit BGRX) and 8-bit PNG (gray, gray +
alpha, RGB, RGBA, paletted) are decoded and encoded here with numpy and
zlib. Colour is reduced to gray with the fixed-point rounding cv2 applies,
so both packages see the same pixels: BT.601 in 14 bits with rounding for
BMP (cv2's own conversion), and libpng's truncating 15-bit conversion for
PNG (cv2 asks libpng for gray). Other formats go to cv2 or PIL when one is
installed.

Three-channel arrays handed to `imwrite` are BGR, as cv2 takes them.
"""

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _gray_bgr_bmp(b, g, r):
    b, g, r = (np.asarray(c, np.int32) for c in (b, g, r))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def _gray_rgb_png(r, g, b):
    r, g, b = (np.asarray(c, np.int32) for c in (r, g, b))
    return ((r * 9797 + g * 19234 + b * 3737) >> 15).astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def _decode_bmp(data):
    """uint8 HW gray image, or None for a BMP variant not handled here."""
    offset = struct.unpack_from("<I", data, 10)[0]
    dib = struct.unpack_from("<I", data, 14)[0]
    if dib == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp, n_colors, entry = 0, 0, 3
    else:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        n_colors = struct.unpack_from("<I", data, 46)[0]
        entry = 4
    top_down = h < 0
    h = abs(h)
    if comp != 0 or bpp not in (8, 24, 32):
        return None
    stride = (w * bpp + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * h,
                         offset=offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n_colors = n_colors or 256
        pal = np.frombuffer(data, np.uint8, count=n_colors * entry,
                            offset=14 + dib).reshape(n_colors, entry)
        lut = np.zeros(256, np.uint8)
        lut[:n_colors] = _gray_bgr_bmp(pal[:, 0], pal[:, 1], pal[:, 2])
        return lut[rows[:, :w]]
    px = rows[:, :w * (bpp // 8)].reshape(h, w, bpp // 8)
    return _gray_bgr_bmp(px[..., 0], px[..., 1], px[..., 2])


def _encode_bmp(img):
    """uint8 HW (8-bit, gray palette) or HWC BGR (24-bit), bottom-up."""
    h, w = img.shape[:2]
    gray = img.ndim == 2
    bpp = 8 if gray else 24
    stride = (w * bpp + 31) // 32 * 4
    palette = (np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
               * np.array([1, 1, 1, 0], np.uint8)).tobytes() if gray else b""
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * (bpp // 8)] = img.reshape(h, -1)
    pixels = rows[::-1].tobytes()
    offset = 14 + 40 + len(palette)
    header = struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, len(pixels),
                       0, 0, 256 if gray else 0, 0)
    return header + info + palette + pixels


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _unfilter_row(kind, line, prev, bpp):
    """Undo one PNG scanline filter (None, Sub, Up, Average, Paeth)."""
    if kind == 0:
        return line
    if kind == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
    if kind == 2:
        return (line + prev) & 255
    if kind not in (3, 4):
        raise ValueError(f"bad PNG filter type {kind}")
    cur = line.tolist()
    up = prev.tolist()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if kind == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 255
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (cur[x] + pred) & 255
    return np.asarray(cur, np.int32)


def _decode_png(data):
    """uint8 HW gray image, or None for a PNG variant not handled here."""
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if depth != 8 or interlace != 0 or channels is None:
        return None
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1).astype(np.int32)
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        prev = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, channels)
        img[y] = prev
    if color == 0:
        return img
    if color == 4:
        return img[:, 0::2].copy()
    if color == 3:
        rgb = plte[img]
    else:
        rgb = img.reshape(h, w, channels)
    return _gray_rgb_png(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode_png(img):
    """uint8 HW (gray) or HWC BGR (stored as RGB), filter None."""
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    px = img if color == 0 else img[..., ::-1]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(px).reshape(h, -1)], axis=1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _imread_other(path):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: format not handled by the built-in "
                         f"BMP/PNG codec, and neither cv2 nor PIL is "
                         f"installed") from None
    return np.asarray(Image.open(path).convert("L"))


def imread_gray(path, dtype=np.float32):
    """Read an image as gray, HW array of `dtype` with values 0..255."""
    with open(path, "rb") as f:
        data = f.read()
    img = None
    if data[:2] == b"BM":
        img = _decode_bmp(data)
    elif data[:8] == _PNG_SIG:
        img = _decode_png(data)
    if img is None:
        img = _imread_other(path)
    return img.astype(dtype)


def imwrite(path, img):
    """Write a uint8 image (HW, HW1, or HWC with 3 BGR channels)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"imwrite: unsupported shape {img.shape}")
    ext = str(path).lower().rsplit(".", 1)[-1]
    if ext == "bmp":
        data = _encode_bmp(img)
    elif ext == "png":
        data = _encode_png(img)
    else:
        try:
            import cv2
        except ImportError:
            raise ValueError(f"{path}: only .bmp and .png are written "
                             f"without cv2") from None
        if not cv2.imwrite(str(path), img):
            raise IOError(f"failed to write {path}")
        return
    with open(path, "wb") as f:
        f.write(data)
