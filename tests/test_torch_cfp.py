"""The port's CFP, Combined_Frequency_Periodicity and ``ops/mxu_fft``
against the JAX package's and against numpy fp64, on the CPU.

CFP is held against the numpy fp64 oracle of tests/test_cfp.py at its
tolerance (``rtol=1e-2, atol=1e-4``) and against the JAX package within
1e-4 of max |ref|; with ``use_mxu_fft`` forced on, within
``3e-4 * max(|ref|, 1)`` of the default path (tests/test_mxu_fft.py:75).
The staged rfft is held against ``np.fft.rfft`` within 2e-5 of max |ref|.
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import nnaudio_tpu as jn
import nnaudio_tpu_torch as tn
from nnaudio_tpu import features as jf
from nnaudio_tpu.ops import mxu_fft as jmx
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.ops import mxu_fft as tmx
from test_cfp import np_cfp_oracle

TOL = 1e-4


@pytest.fixture
def mxu_fft_off_after():
    yield
    tn.set_use_mxu_fft(None)
    jn.set_use_mxu_fft(None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ------------------------------------------------------------------- CFP --
def test_cfp_matches_numpy_oracle_and_jax():
    x = np.random.RandomState(0).randn(16000).astype(np.float32)
    Z = tf.CFP(device="cpu")(x[None])
    Z_ref, _, _, _ = np_cfp_oracle(x)
    assert np.allclose(_np(Z)[0], Z_ref, rtol=1e-2, atol=1e-4)
    _close(Z, jf.CFP()(x[None]))


def test_combined_frequency_periodicity_matches_oracle_and_jax():
    x = np.random.RandomState(1).randn(16000).astype(np.float32)
    got = tf.Combined_Frequency_Periodicity(device="cpu")(x[None])
    refs = np_cfp_oracle(x, trim_edges=True)
    want = jf.Combined_Frequency_Periodicity()(x[None])
    for g, r, w in zip(got, refs, want):
        assert np.allclose(_np(g)[0], r, rtol=1e-2, atol=1e-4)
        _close(g, w)


@pytest.mark.parametrize("kw,tol", [
    (dict(fs=8000, fr=4, hop_length=160, window_size=1025, fc=100, tc=1 / 500,
          NumPerOct=24), TOL),
    (dict(g=(0.24, 0.6, 1, 0.8)), TOL),   # four layers: the final one is cepstral
    # a log layer: log(relu(x) + 1e-8) magnifies the transform's fp32
    # rounding where x is near 0, so 1e-3
    (dict(g=(0.5, 0)), 1e-3),
    (dict(fr=2.5, fs=16000, hop_length=256), TOL),  # N = 6400
])
def test_cfp_configs_match_jax(kw, tol):
    x = np.random.RandomState(2).randn(2, 12000).astype(np.float32)
    got = tf.Combined_Frequency_Periodicity(device="cpu", **kw)(x)
    want = jf.Combined_Frequency_Periodicity(**kw)(x)
    for g, w in zip(got, want):
        _close(g, w, tol)


def test_cfp_cutoff_mask_half_spectrum_semantics():
    """tests/test_cfp.py:89: nnAudio's exact mask membership, the edge
    c == N/2 included."""
    layer = tf.CFP(device="cpu")
    n, half = layer.N, layer.half
    v = torch.ones(1, 1, half)
    for c in (0, 1, 16, n // 4, n // 2 - 1, n // 2, float(n // 4)):
        out = _np(layer._nonlinear(v, 1.0, c))[0, 0]
        full = np.ones(n)
        if int(c) > 0:
            full[:int(c)] = 0
            full[-int(c):] = 0
        assert np.array_equal(out, full[:half].astype(np.float32)), c


def test_cfp_timestep_alignment_and_state():
    x = np.random.RandomState(2).randn(1, 16000).astype(np.float32)
    cfp = tf.CFP(device="cpu")
    z_new = cfp(x)
    z_orig, *_ = tf.Combined_Frequency_Periodicity(device="cpu")(x)
    assert z_new.shape[-1] == z_orig.shape[-1] + 2
    assert set(cfp.state_dict()) == set(jf.CFP().state_dict())
    assert np.array_equal(cfp.t, np.arange(320, 16000, 320))


def test_cfp_mxu_fft_matches_default(mxu_fft_off_after):
    """tests/test_mxu_fft.py:64: the staged FFT against torch.fft, and
    against the JAX package's staged FFT."""
    x = np.random.RandomState(2).randn(1, 32000).astype(np.float32)
    m = tf.Combined_Frequency_Periodicity(fs=16000, hop_length=320, device="cpu")
    base = m(x)
    tn.set_use_mxu_fft(True)
    fast = m(x)
    jn.set_use_mxu_fft(True)
    jfast = jf.Combined_Frequency_Periodicity(fs=16000, hop_length=320)(x)
    for a, b, c in zip(fast, base, jfast):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 3e-4 * scale
        assert np.abs(_np(a) - np.asarray(c)).max() <= 3e-4 * scale


# --------------------------------------------------------------- mxu_fft --
@pytest.mark.parametrize("m", [4000, 8000, 1024, 3200, 3 * 641, 22050, 2, 1])
def test_split_factors_match_jax(m):
    assert tmx._split_factors(m) == jmx._split_factors(m)


@pytest.mark.parametrize("n", [8000, 2048, 6400, 500, 4, 250, 256, 16000])
def test_rfft_matches_numpy(n):
    x = np.random.RandomState(0).randn(3, n).astype(np.float32)
    re, im = tmx.rfft_mxu(torch.from_numpy(x))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = np.abs(want).max()
    assert np.abs(_np(re) - want.real).max() <= 2e-5 * scale
    assert np.abs(_np(im) - want.imag).max() <= 2e-5 * scale


def test_rfft_unsupported_returns_none():
    for n in (31, 2 * 3 * 641, 2, 44100):
        assert tmx.rfft_mxu(torch.zeros(2, n)) is None
        assert jmx.rfft_mxu(jnp.zeros((2, n))) is None


def test_rfft_pure_tone_phase():
    n, k = 4000, 137
    t = np.arange(n)
    x = np.cos(2 * np.pi * k * t / n + 0.3).astype(np.float32)[None]
    re, im = tmx.rfft_mxu(torch.from_numpy(x))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(_np(re) - want.real).max() <= 2e-3
    assert np.abs(_np(im) - want.imag).max() <= 2e-3
    assert abs(float(re[0, k]) - n / 2 * math.cos(0.3)) < 1e-2


def test_rfft_batched_shapes_match_jax():
    x = np.random.RandomState(1).randn(2, 5, 2048).astype(np.float32)
    re, im = tmx.rfft_mxu(torch.from_numpy(x))
    assert re.shape == im.shape == (2, 5, 1025)
    jre, jim = jmx.rfft_mxu(jnp.asarray(x))
    _close(re, jre)
    _close(im, jim)
