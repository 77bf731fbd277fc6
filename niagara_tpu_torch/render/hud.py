"""Debug-text HUD overlay on tensors (niagara_tpu/render/hud.py): a 3x5
bitmap font (digits, the punctuation and the lowercase letters the HUD
uses; anything else draws blank) blended into the image with a drop
shadow, on the image's device."""

from __future__ import annotations

import numpy as np
import torch

# 3x5 glyphs, rows top->bottom, each row is 3 bits (MSB = left pixel);
# the reference's table (hud.py:14)
_GLYPHS = {
    "0": [0b111, 0b101, 0b101, 0b101, 0b111],
    "1": [0b010, 0b110, 0b010, 0b010, 0b111],
    "2": [0b111, 0b001, 0b111, 0b100, 0b111],
    "3": [0b111, 0b001, 0b111, 0b001, 0b111],
    "4": [0b101, 0b101, 0b111, 0b001, 0b001],
    "5": [0b111, 0b100, 0b111, 0b001, 0b111],
    "6": [0b111, 0b100, 0b111, 0b101, 0b111],
    "7": [0b111, 0b001, 0b010, 0b010, 0b010],
    "8": [0b111, 0b101, 0b111, 0b101, 0b111],
    "9": [0b111, 0b101, 0b111, 0b001, 0b111],
    ".": [0b000, 0b000, 0b000, 0b000, 0b010],
    ":": [0b000, 0b010, 0b000, 0b010, 0b000],
    "/": [0b001, 0b001, 0b010, 0b100, 0b100],
    "%": [0b101, 0b001, 0b010, 0b100, 0b101],
    "-": [0b000, 0b000, 0b111, 0b000, 0b000],
    " ": [0b000, 0b000, 0b000, 0b000, 0b000],
    "a": [0b000, 0b011, 0b101, 0b101, 0b011],
    "b": [0b100, 0b110, 0b101, 0b101, 0b110],
    "c": [0b000, 0b011, 0b100, 0b100, 0b011],
    "d": [0b001, 0b011, 0b101, 0b101, 0b011],
    "e": [0b010, 0b101, 0b111, 0b100, 0b011],
    "f": [0b001, 0b010, 0b111, 0b010, 0b010],
    "g": [0b011, 0b101, 0b011, 0b001, 0b110],
    "h": [0b100, 0b110, 0b101, 0b101, 0b101],
    "i": [0b010, 0b000, 0b010, 0b010, 0b010],
    "k": [0b100, 0b101, 0b110, 0b110, 0b101],
    "l": [0b010, 0b010, 0b010, 0b010, 0b010],
    "m": [0b000, 0b110, 0b111, 0b101, 0b101],
    "n": [0b000, 0b110, 0b101, 0b101, 0b101],
    "o": [0b000, 0b010, 0b101, 0b101, 0b010],
    "p": [0b000, 0b110, 0b101, 0b110, 0b100],
    "r": [0b000, 0b011, 0b100, 0b100, 0b100],
    "s": [0b000, 0b011, 0b110, 0b001, 0b110],
    "t": [0b010, 0b111, 0b010, 0b010, 0b001],
    "u": [0b000, 0b101, 0b101, 0b101, 0b011],
    "v": [0b000, 0b101, 0b101, 0b101, 0b010],
    "w": [0b000, 0b101, 0b101, 0b111, 0b011],
    "x": [0b000, 0b101, 0b010, 0b010, 0b101],
    "y": [0b101, 0b101, 0b011, 0b001, 0b110],
    "z": [0b000, 0b111, 0b001, 0b010, 0b111],
}

GLYPH_W, GLYPH_H = 4, 6  # 3x5 pixels + 1px spacing


def _text_bitmap(text: str) -> np.ndarray:
    """`text` as a [GLYPH_H, len * GLYPH_W] 0/1 bitmap."""
    out = np.zeros((GLYPH_H, len(text) * GLYPH_W), dtype=np.float32)
    for i, ch in enumerate(text.lower()):
        for r, bits in enumerate(_GLYPHS.get(ch, _GLYPHS[" "])):
            for c in range(3):
                if bits & (1 << (2 - c)):
                    out[r, i * GLYPH_W + c] = 1.0
    return out


def draw_text(image: torch.Tensor, text: str, x: int, y: int, color=(1.0, 1.0, 1.0), scale: int = 2) -> torch.Tensor:
    """`image` [H, W, 3] with `text` blended in at pixel (x, y), clipped to
    the image, over a drop shadow shifted by `scale` (hud.py:75).  Returns
    a new tensor."""
    bitmap = _text_bitmap(text)
    if scale != 1:
        bitmap = np.kron(bitmap, np.ones((scale, scale), dtype=np.float32))
    h, w = image.shape[:2]
    bh, bw = min(bitmap.shape[0], h - y), min(bitmap.shape[1], w - x)
    if bh <= 0 or bw <= 0:
        return image
    bm = bitmap[:bh, :bw, None]
    sh = np.zeros_like(bm)
    sh[scale:, scale:] = bm[:-scale, :-scale]
    bm, sh = (torch.from_numpy(a).to(image.device) for a in (bm, sh))
    col = torch.tensor(color, dtype=torch.float32, device=image.device)
    out = image.clone()
    out[y:y + bh, x:x + bw] = image[y:y + bh, x:x + bw] * (1 - sh) * (1 - bm) + bm * col
    return out


def draw_hud(image: torch.Tensor, lines: list[str], color=(1.0, 1.0, 1.0), scale: int = 2) -> torch.Tensor:
    """Text lines stacked in the top-left corner (hud.py:95)."""
    y = 4
    for line in lines:
        image = draw_text(image, line, 4, y, color=color, scale=scale)
        y += (GLYPH_H + 1) * scale
    return image
