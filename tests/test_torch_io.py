"""The port's own BMP/PNG codec against cv2 and PIL: gray and colour, odd
widths (BMP rows pad to 4 bytes), every PNG filter type, and the gray
conversion cv2 applies (the JAX package reads through cv2)."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from multi_modal_image_fusion_tpu_torch.data import io as pio

SHAPES = [(17, 23), (32, 64), (5, 1)]


def _img(shape, seed, channels=0):
    r = np.random.RandomState(seed)
    full = shape + ((channels,) if channels else ())
    return (r.rand(*full) * 255).astype(np.uint8)


@pytest.mark.parametrize("ext", ["bmp", "png"])
@pytest.mark.parametrize("shape", SHAPES)
def test_write_gray_read_by_cv2_and_pil(tmp_path, ext, shape):
    img = _img(shape, 0)
    path = str(tmp_path / f"g.{ext}")
    pio.imwrite(path, img[..., None])
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                  img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(pio.imread_gray(path), img)


@pytest.mark.parametrize("ext", ["bmp", "png"])
@pytest.mark.parametrize("shape", SHAPES)
def test_write_colour_read_by_cv2(tmp_path, ext, shape):
    bgr = _img(shape, 1, 3)
    path = str(tmp_path / f"c.{ext}")
    pio.imwrite(path, bgr)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), bgr)
    np.testing.assert_array_equal(pio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("ext,writer,mode", [
    (ext, writer, mode) for ext in ("bmp", "png")
    for writer in ("cv2", "pil")
    for mode in ("L", "RGB", "P", "RGBA", "LA")
    # BMP variants here carry no alpha; cv2 writes no paletted or
    # gray+alpha files
    if not (ext == "bmp" and mode in ("RGBA", "LA"))
    and not (writer == "cv2" and mode in ("P", "LA"))])
def test_read_matches_cv2_gray(tmp_path, ext, writer, mode):
    shape = (19, 29)
    rgb = _img(shape, 2, 3)
    path = str(tmp_path / f"x.{ext}")
    if writer == "cv2":
        arr = {"L": rgb[..., 0], "RGB": rgb,
               "RGBA": np.dstack([rgb, rgb[..., :1]])}[mode]
        assert cv2.imwrite(path, arr)
    else:
        im = Image.fromarray(rgb)
        im = im.convert(mode) if mode != "P" else im.quantize(64)
        im.save(path)
    np.testing.assert_array_equal(pio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _png_with_filters(img, filters):
    """8-bit gray PNG whose rows use the given filter types."""
    h, w = img.shape
    x = img.astype(np.int32)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = x[y]
        up = x[y - 1] if y else np.zeros(w, np.int32)
        left = np.concatenate([[0], cur[:-1]])
        ul = np.concatenate([[0], up[:-1]])
        if kind == 0:
            pred = np.zeros(w, np.int32)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_all_filter_types(tmp_path):
    img = _img((12, 21), 3)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
    np.testing.assert_array_equal(pio.imread_gray(str(path)), img)


def test_imwrite_rejects_non_uint8(tmp_path):
    with pytest.raises(TypeError):
        pio.imwrite(str(tmp_path / "x.bmp"), np.zeros((4, 4), np.float32))
