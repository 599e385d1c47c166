"""Plain (P3) PPM writer, byte-compatible with the reference.

Format layout from ppm_image.zig:20-45: header comments, bottom-up row
order (ppm_image.zig:37) and ``clamp(trunc(255.999 * c), 0, 255)``
quantization (ppm_image.zig:11-15). The reference's determinism anchor —
a 10x10 all-black image is exactly 1,446 bytes for the reference filename
(ppm_image.zig:82) — holds for this writer too.
"""

from __future__ import annotations

import numpy as np


def _convert(v: np.ndarray) -> np.ndarray:
    # trunc first, then clamp, matching ppm_image.zig:11-15.
    return np.clip((v * 255.999).astype(np.int64), 0, 255)


def write_ppm(path, image: np.ndarray, header_filename: str | None = None) -> None:
    """Write ``(H, W, 3)`` f32 (row 0 = bottom) as plain PPM."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    name = header_filename if header_filename is not None else str(path)
    vals = _convert(image)
    lines = [
        "P3",
        f"# filename: {name}",
        "# The P3 = colors are in ASCII",
        "# Image width and height",
        f"{w} {h}",
        "# Max color value",
        "255",
        "# RGB triplets",
    ]
    out = ["\n".join(lines) + "\n"]
    for y in range(h - 1, -1, -1):  # bottom-up, ppm_image.zig:37
        row = vals[y]
        out.append(
            "".join(f"{row[x, 0]: >3} {row[x, 1]: >3} {row[x, 2]: >3}  " for x in range(w))
            + "\n"
        )
    with open(path, "w") as f:
        f.write("".join(out))
