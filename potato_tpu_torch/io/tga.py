"""TGA image codec (uncompressed true-color only), numpy implementation.

- load: accepts only id_length=0, colormap_type=0, datatype 2
  (uncompressed BGR/BGRA), 24 or 32 bpp; honours the vertical-flip bit
  (bit 5 of image_desc); returns RGBA uint8.
- save: writes 32-bpp BGRA with a zeroed descriptor (no flip bit), rows in
  array order.

Image arrays are (height, width, 4) uint8, row j=0 first: pixel (i, j) is
storage[i + j*width] of the file's pixel data.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<BBB5sHHHHBB")  # 18 bytes


class TgaError(ValueError):
    pass


def load(path_or_bytes, use_native: bool = True) -> np.ndarray:
    """Load a TGA file (a path, or its bytes) -> (H, W, 4) uint8 RGBA."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if use_native:
        from potato_tpu_torch.io import native

        img = native.tga_decode(data)
        if img is not None:
            return img

    if len(data) < _HEADER.size:
        raise TgaError("truncated TGA header")
    (id_length, colormap_type, datatype, _cmap_spec, _x0, _y0,
     width, height, bpp, image_desc) = _HEADER.unpack_from(data, 0)

    ok = (id_length == 0 and colormap_type == 0 and datatype == 2
          and bpp in (24, 32))
    if not ok:
        raise TgaError(
            f"unsupported TGA header: datatype={datatype} bpp={bpp} "
            f"id_length={id_length} colormap={colormap_type}")

    channels = bpp // 8
    need = _HEADER.size + width * height * channels
    if len(data) < need:
        raise TgaError("truncated TGA pixel data")

    raw = np.frombuffer(data, np.uint8, count=width * height * channels,
                        offset=_HEADER.size)
    img = raw.reshape(height, width, channels)

    out = np.empty((height, width, 4), np.uint8)
    out[..., 0] = img[..., 2]  # B G R (A) -> R G B A
    out[..., 1] = img[..., 1]
    out[..., 2] = img[..., 0]
    out[..., 3] = img[..., 3] if channels == 4 else 255

    if image_desc & (1 << 5):
        # flip bit set: the file's rows run top to bottom
        out = out[::-1]
    return np.ascontiguousarray(out)


def encode(image: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA (or (H, W, 3) RGB) -> 32-bpp BGRA TGA bytes."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise TgaError(f"expected (H, W, 3|4) uint8, got {image.shape}")
    if image.dtype != np.uint8:
        raise TgaError(f"expected uint8, got {image.dtype}")
    h, w = image.shape[:2]

    header = _HEADER.pack(0, 0, 2, b"\0" * 5, 0, 0, w, h, 32, 0)
    bgra = np.empty((h, w, 4), np.uint8)
    bgra[..., 0] = image[..., 2]
    bgra[..., 1] = image[..., 1]
    bgra[..., 2] = image[..., 0]
    bgra[..., 3] = image[..., 3] if image.shape[2] == 4 else 255
    return header + bgra.tobytes()


def save(image: np.ndarray, path: str) -> None:
    """Save (H, W, 4) uint8 RGBA (or (H, W, 3) RGB) as 32-bpp BGRA TGA."""
    data = encode(image)
    with open(path, "wb") as f:
        f.write(data)
