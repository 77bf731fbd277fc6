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
