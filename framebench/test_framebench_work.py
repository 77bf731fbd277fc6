"""The work counts of core/work.py on hand-made cases."""

from __future__ import annotations

import pytest
import torch

import tinyrun  # noqa: F401  (puts framebench on sys.path)
from core import work


def test_setup_work_by_hand():
    tc = dict(count=torch.tensor([2]), mi=torch.tensor([5, 5, 9]), post_pass=torch.tensor([1, 0, 1]),
              tri_count=torch.tensor([3, 4, 90]))
    out = dict(count=torch.tensor(5))
    # 2 live clusters x (6 words + 32 bytes), 1 distinct meshlet x (96x3 ids,
    # 64x8 f32, 64 ids), 5 records x (224 + 16 + 4); 420 x 7 live triangles
    assert work.setup_work(tc, out, alpha=False) == (2 * 56 + 3456 + 5 * 244, 420 * 7)
    # with masks: the one distinct meshlet of a post class adds 8 x 96 words
    assert work.setup_work(tc, out, alpha=True) == (2 * 56 + 3456 + 5 * 244 + 3072, 420 * 7)


def test_raster_work_by_hand():
    rec = torch.zeros(1, 56)
    rec[0, [12, 14, 15]] = torch.tensor([0.0, 10.0, 4.0])  # x0, x1, y1
    rec[0, [17, 25, 33]] = torch.tensor([0.0, 2.0, 4.0])  # corner ys: y0 = 0
    rec[0, [18, 26, 34]] = 1.0  # corners in front of the eye
    ts, pt = torch.tensor([0, 1]), torch.tensor([0])
    nbytes, ops = work.raster_work((ts, pt, rec), False, 8, 128, 1)
    # tile starts, one pair, 13 staged columns, 16 bytes a pixel of 8x128
    assert nbytes == 2 * 4 + 4 + 13 * 4 + 8 * 128 * 16
    assert ops == 28 * 10 * 4  # the 10 x 4 pixels of the box in the tile
    # a band 1 tile row down: the box lies above it, no pixel tested
    assert work.raster_work((ts, pt, rec), False, 8, 128, 1, band_row0=1)[1] == 0


def test_bound_takes_the_larger():
    assert work.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert work.bound_ms(0, 67e12) == pytest.approx(1e3)
    assert work.bound_ms(3.35e9, 67e12) == pytest.approx(1e3)
