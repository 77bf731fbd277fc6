"""niagara_tpu_torch/ops/bloom.py against the JAX reference
(niagara_tpu/ops/bloom.py), run op by op, on seeded g0 [H, W, 4] with
nonzero emissive at an odd size (23x37), an even one (24x36) and 1080x1920.

* `_down2`, `_up2` (to an odd and an even size), `_bilinear_x2` and
  `sample_bloom_fullres` on the same inputs: exact (the same f32 ops in the
  same order; edge padding is a copy).
* `extract_emissive` and `compute_bloom` on random g0: within rtol 4e-7 +
  atol 1e-6 (measured worst: 1.7e-6 relative on small values, 3.8e-6
  absolute on values near 23 at 1080p): `pow` (sRGB decode) and `exp2` come
  from XLA's and PyTorch's CPU math libraries, which differ in the last
  bits; the 2x2 box sum and the chain's filters add nothing to it.
* On g0 whose decode is exact in both libraries (albedo 0 or 1, emissive
  code a multiple of 0.2, so exp2 of an integer), `extract_emissive` and
  the whole chain: exact, which holds the box sum's order and the chain's
  composition to the reference's.

* The chain as the card splits it (`split_chain`: `_down2`/`up2_add_plain`
  on the levels above `tail_start`, then the tail's plain twin
  `tail_plain`): the split rule at 1920x1080 (the tail from mip 4),
  256x128 (from mip 1), 23x37 and 24x36 (the whole chain), 1x1 and
  16384x16384 (no tail: fewer than two levels left); bit for bit with
  `bloom_chain` at every
  start, within RTOL/ATOL of the reference's compute_bloom and exact on the
  exactly decoded input.

The kernels (csrc/bloom.cu) are held to these plain versions bit for bit
on the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import bloom as jbloom
from niagara_tpu_torch.ops import bloom

SIZES = [(23, 37), (24, 36), (1080, 1920)]
RTOL, ATOL = 4e-7, 1e-6


def _g0(seed, h, w, exact=False):
    rng = np.random.default_rng(seed)
    g0 = np.empty((h, w, 4), np.float32)
    if exact:
        g0[..., :3] = rng.integers(0, 2, (h, w, 3))
        g0[..., 3] = rng.integers(0, 4, (h, w)).astype(np.float32) * np.float32(0.2)
    else:
        g0[...] = rng.uniform(0.0, 1.0, (h, w, 4))
    return g0


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def emissive(request):
    """(g0, the reference's half-resolution emissive) at one size."""
    h, w = request.param
    g0 = _g0(h + w, h, w)
    return g0, np.asarray(jbloom.extract_emissive(jnp.asarray(g0), w, h))


def test_bloom_levels_match_reference():
    for w, h in [(1920, 1080), (256, 128), (37, 23), (1, 1), (3, 200)]:
        assert bloom.bloom_levels(w, h) == jbloom.bloom_levels(w, h)
    assert bloom.bloom_levels(1920, 1080) == 8


def test_tables_match_reference():
    np.testing.assert_array_equal(bloom._DOWN_K, jbloom._DOWN_K)
    assert bloom._UP_K.keys() == jbloom._UP_K.keys()
    for k in jbloom._UP_K:
        np.testing.assert_array_equal(bloom._UP_K[k], jbloom._UP_K[k])


def test_filters_exact(emissive):
    _, e = emissive
    src = torch.from_numpy(e.copy())
    np.testing.assert_array_equal(bloom._down2(src).numpy(), np.asarray(jbloom._down2(jnp.asarray(e))))
    h, w = e.shape[1:]
    for oh, ow in [(2 * h, 2 * w), (2 * h - 1, 2 * w - 1)]:
        np.testing.assert_array_equal(bloom._up2(src, oh, ow).numpy(), np.asarray(jbloom._up2(jnp.asarray(e), oh, ow)))
        np.testing.assert_array_equal(bloom._bilinear_x2(src, oh, ow).numpy(),
                                      np.asarray(jbloom._bilinear_x2(jnp.asarray(e), oh, ow)))
    mip = np.asarray(jbloom._up2(jnp.asarray(e), 2 * h - 1, 2 * w))
    np.testing.assert_array_equal(bloom.up2_add_plain(src, torch.from_numpy(mip.copy())).numpy(),
                                  mip + np.asarray(jbloom._up2(jnp.asarray(e), 2 * h - 1, 2 * w)))


def test_sample_bloom_fullres_exact(emissive):
    g0, e = emissive
    h, w = g0.shape[:2]
    got = bloom.sample_bloom_fullres(torch.from_numpy(e.copy()), w, h).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, np.asarray(jbloom.sample_bloom_fullres(jnp.asarray(e), w, h)))


def test_extract_and_chain_within_math_library_tolerance(emissive):
    g0, e = emissive
    h, w = g0.shape[:2]
    got = bloom.extract_emissive(torch.from_numpy(g0), w, h).numpy()
    assert got.shape == e.shape == (3, (h + 1) // 2, (w + 1) // 2)
    np.testing.assert_allclose(got, e, rtol=RTOL, atol=ATOL)
    ref = np.asarray(jbloom.compute_bloom(jnp.asarray(g0), w, h))
    out = bloom.compute_bloom(torch.from_numpy(g0), w, h).numpy()
    assert out.shape == ref.shape and (ref > 0).all()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_chain_exact_on_exactly_decoded_input(size):
    h, w = size
    g0 = _g0(7, h, w, exact=True)
    e = bloom.extract_emissive(torch.from_numpy(g0), w, h).numpy()
    np.testing.assert_array_equal(e, np.asarray(jbloom.extract_emissive(jnp.asarray(g0), w, h)))
    assert np.unique(e).size > 10, "the box sum sees distinct values"
    np.testing.assert_array_equal(bloom.compute_bloom(torch.from_numpy(g0), w, h).numpy(),
                                  np.asarray(jbloom.compute_bloom(jnp.asarray(g0), w, h)))


def test_cpu_tensors_take_the_plain_filters():
    """On the CPU, compute_bloom is bloom_chain over the plain filters and
    launches no kernel."""
    from niagara_tpu_torch import _build

    g0 = torch.from_numpy(_g0(3, 23, 37))
    before = dict(_build.LAUNCHES)
    out = bloom.compute_bloom(g0, 37, 23)
    assert torch.equal(out, bloom.bloom_chain(g0, 37, 23, bloom._down2, bloom.up2_add_plain))
    assert _build.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no kernel"):
        bloom.down2_cuda(out)


def _split(g0, w, h, start=None):
    """The chain as compute_bloom splits it on the card, on the plain
    filters and the tail's plain twin (at `start`, or the rule's)."""
    levels = bloom.bloom_levels(w, h)
    mip0 = bloom.extract_emissive(torch.from_numpy(g0), w, h)
    if start is None:
        start = bloom.tail_start(levels, *mip0.shape[1:])
    return bloom.split_chain(mip0, levels, start, bloom._down2, bloom.up2_add_plain, bloom.tail_plain)


@pytest.mark.parametrize("size, start, tail", [((1920, 1080), 4, 4), ((256, 128), 1, 7), ((37, 23), 0, 5),
                                               ((36, 24), 0, 5), ((1, 1), 0, 1), ((16384, 16384), 7, 1)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_tail_start_rule(size, start, tail):
    """The tail starts at the first level whose mips down to the last fit in
    TAIL_SPLIT_BYTES (within what the tail can hold), and runs only with two
    levels or more (1x1 has one level; at 16384x16384 only the last mip
    fits)."""
    w, h = size
    levels = bloom.bloom_levels(w, h)
    got = bloom.tail_start(levels, (h + 1) // 2, (w + 1) // 2)
    assert (got, levels - got) == (start, tail)
    sizes = bloom.level_sizes((h + 1) // 2, (w + 1) // 2, levels)
    assert bloom.TAIL_SPLIT_BYTES <= bloom.TAIL_SMEM_BYTES
    assert sum(3 * lh * lw * 4 for lh, lw in sizes[got:]) <= bloom.TAIL_SPLIT_BYTES
    assert got == 0 or sum(3 * lh * lw * 4 for lh, lw in sizes[got - 1:]) > bloom.TAIL_SPLIT_BYTES


@pytest.mark.parametrize("size", [(23, 37), (24, 36), (128, 256), (200, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_chain_exact_at_every_start(size):
    """Large levels by the plain filters down to any start, the tail's plain
    twin, then back up: bloom_chain's result bit for bit."""
    h, w = size
    g0 = _g0(11, h, w)
    ref = bloom.bloom_chain(torch.from_numpy(g0), w, h, bloom._down2, bloom.up2_add_plain)
    for start in range(bloom.bloom_levels(w, h) + 1):
        assert torch.equal(_split(g0, w, h, start).view(torch.int32), ref.view(torch.int32)), start


def test_tail_plain_levels_and_layout():
    """tail_plain writes the downs' levels, then the ups' back to its
    source's size, the last being the chain's accumulated level; the
    kernel's output layout holds them in that order, 256-byte aligned and
    apart."""
    src = torch.from_numpy(np.random.default_rng(5).uniform(0, 4, (3, 68, 120)).astype(np.float32))
    written = bloom.tail_plain(src, 5)
    shapes = [tuple(t.shape[1:]) for t in written]
    assert shapes == [(34, 60), (17, 30), (9, 15), (5, 8), (9, 15), (17, 30), (34, 60), (68, 120)]
    mips = [src] + written[:4]
    acc = mips[-1]
    for mip in mips[-2::-1]:
        acc = bloom.up2_add_plain(acc, mip)
    assert torch.equal(written[-1], acc)
    levels, floats, layout = bloom.tail_layout(68, 120, 5)
    assert [hw for _, hw in layout] == shapes and levels.n == 5
    ends = 0
    for off, (lh, lw) in layout:
        assert off % 64 == 0 and off >= ends
        ends = off + 3 * lh * lw
    assert floats >= ends and list(levels.down_off[1:5]) == [o for o, _ in layout[:4]]
    assert list(levels.up_off[:4]) == [o for o, _ in layout[4:]][::-1]


def test_split_chain_against_reference(emissive):
    """The split chain against the reference's compute_bloom, within the
    math libraries' last bits (the extract's pow and exp2)."""
    g0, _ = emissive
    h, w = g0.shape[:2]
    ref = np.asarray(jbloom.compute_bloom(jnp.asarray(g0), w, h))
    np.testing.assert_allclose(_split(g0, w, h).numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_chain_exact_on_exactly_decoded_input(size):
    h, w = size
    g0 = _g0(7, h, w, exact=True)
    np.testing.assert_array_equal(_split(g0, w, h).numpy(), np.asarray(jbloom.compute_bloom(jnp.asarray(g0), w, h)))
