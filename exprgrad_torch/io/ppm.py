"""PPM/PGM image IO for uint8 tensors.

Parity: reference exprgrad/io/ppmformat.nim:19-83 (P2/P3/P5/P6 variants).
Grayscale arrays of shape [H, W] or [H, W, 1] write PGM (P5); [H, W, 3]
writes PPM (P6).  ASCII variants (P2/P3) are read-supported.
"""

from __future__ import annotations

import numpy as np

from ..errors import ModelRuntimeError


def save_ppm(arr: np.ndarray, path: str) -> None:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ModelRuntimeError("save_ppm expects a uint8 array")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.ndim == 2:
        header = f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n"
    elif arr.ndim == 3 and arr.shape[2] == 3:
        header = f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n"
    else:
        raise ModelRuntimeError(f"cannot save shape {arr.shape} as PPM")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())


def load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P"):
        raise ModelRuntimeError(f"{path} is not a PPM/PGM file")
    kind = data[:2].decode("ascii")

    # tokenize header (comments start with #)
    pos = 2
    tokens: list[int] = []
    while len(tokens) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    width, height, maxval = tokens
    channels = 3 if kind in ("P3", "P6") else 1

    if kind in ("P5", "P6"):
        pixels = np.frombuffer(
            data, dtype=np.uint8, count=width * height * channels, offset=pos
        )
    elif kind in ("P2", "P3"):
        pixels = np.array(data[pos:].split(), dtype=np.int64).astype(np.uint8)
    else:
        raise ModelRuntimeError(f"unsupported PPM variant {kind}")
    if channels == 1:
        return pixels.reshape(height, width)
    return pixels.reshape(height, width, channels)
