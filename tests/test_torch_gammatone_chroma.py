"""The port's Gammatonegram and ChromaSTFT, and its copies of the gammatone,
chroma and CFP filter builders, against the JAX package's on the same numpy
inputs, on the CPU. The builders must be equal to the bit; the transforms
and their gradients agree within 1e-4 of max |ref| (the framed ops'
tolerance, tests/test_ops.py).

Each transform also runs on the route of a CUDA tensor (``kernel_route`` of
tests/test_torch_training.py: every wrapper takes its card branch, each
launch replaced by its plain version and counted): at ``power=2`` one
filterbank launch (K2), and under grad the pair (K5) alone.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu import filters as jfl
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch import filters as tfl
from nnaudio_tpu_torch.interop import load_jax_state
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

TOL = 1e-4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------- filters --
FILTER_CASES = {
    # tests/test_filters.py:120-122 and the transforms' defaults
    "gammatone 22050/1024/64": lambda m: m.gammatone_filterbank(22050, 1024, 64),
    "gammatone 22050/2048/64 fmin 0": lambda m: m.gammatone_filterbank(
        22050, 2048, 64, fmin=0.0),
    "gammatone 16000/512/32 50-7000": lambda m: m.gammatone_filterbank(
        16000, 512, 32, fmin=50.0, fmax=7000.0),
    "gammatone weights maxlen 300": lambda m: m.fft_to_gammatone_weights(
        22050, 1024, 40, width=1.5, fmin=30.0, fmax=8000.0, maxlen=300)[0],
    "gammatone center freqs": lambda m: m.gammatone_center_freqs(64, 20.0, 11025.0),
    "chroma 22050/1024": lambda m: m.chroma_filterbank(22050, 1024),
    "chroma 22050/2048": lambda m: m.chroma_filterbank(22050, 2048),
    "chroma 24 bins, tuning, norm inf": lambda m: m.chroma_filterbank(
        44100, 4096, n_chroma=24, tuning=0.3, norm=np.inf),
    "chroma no octwidth, no base_c, norm 1": lambda m: m.chroma_filterbank(
        16000, 512, octwidth=None, base_c=False, norm=1),
    "chroma norm None": lambda m: m.chroma_filterbank(22050, 1024, norm=None),
    "hz_to_octs": lambda m: m.hz_to_octs(np.array([27.5, 440.0, 4186.0]), 0.25),
    "cfp log freqs": lambda m: m.log_central_freqs(80.0, 1 / 1000, 48),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_builders_equal_jax(case):
    got, want = FILTER_CASES[case](tfl), FILTER_CASES[case](jfl)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fs,fr,fc,tc", [(16000, 2, 80, 1 / 1000),
                                         (8000, 4, 100, 1 / 500)])
def test_cfp_logfreq_matrices_equal_jax(fs, fr, fc, tc):
    n = int(fs / fr)
    f = fs * np.linspace(0, 0.5, n // 2, endpoint=True)[: int(round(1 / tc / fr) + 1)]
    q = np.arange(int(round(fs / fc) + 1)) / float(fs)
    for got, want in zip(tfl.cfp_logfreq_matrices(f, q, fr, fc, tc, 48, fs),
                         jfl.cfp_logfreq_matrices(f, q, fr, fc, tc, 48, fs)):
        assert np.array_equal(got, want)


# ------------------------------------------------------------- transforms --
SMALL = dict(sr=16000, n_fft=512, hop_length=128, verbose=False)


def _signal(n=8000, batch=2, seed=0):
    return np.random.RandomState(seed).randn(batch, n).astype(np.float32)


def _pair(cls, **kw):
    return getattr(jf, cls)(**SMALL, **kw), getattr(tf, cls)(**SMALL, **kw, device="cpu")


@pytest.mark.parametrize("power", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("trainable_STFT", [False, True])
def test_gammatonegram_matches_jax(power, trainable_STFT):
    jl, tl = _pair("Gammatonegram", n_bins=32, power=power,
                   trainable_STFT=trainable_STFT)
    x = _signal()
    with torch.no_grad():
        _close(tl(x), jl(jnp.asarray(x)))


@pytest.mark.parametrize("norm", [math.inf, 2, 1, None])
@pytest.mark.parametrize("power", [2.0, 1.0])
def test_chroma_stft_matches_jax(norm, power):
    jl, tl = _pair("ChromaSTFT", norm=norm, power=power)
    x = _signal(seed=1)
    with torch.no_grad():
        _close(tl(x), jl(jnp.asarray(x)))


def test_chroma_default_norm_is_math_inf():
    tl = tf.ChromaSTFT(verbose=False, device="cpu")
    assert tl.norm == math.inf and tl.chroma_basis.shape == (12, 1025)


@pytest.mark.parametrize("norm", [math.inf, 2, 0.5, None])
def test_normalize_frames_matches_jax(norm):
    from nnaudio_tpu.features.chroma import normalize_frames as jnorm

    c = np.abs(np.random.RandomState(2).randn(2, 12, 9)).astype(np.float32)
    c[0, :, 3] = 0.0  # a silent frame keeps its zeros
    _close(tf.normalize_frames(torch.from_numpy(c), norm),
           jnorm(jnp.asarray(c), jnp.inf if norm == math.inf else norm))


@pytest.mark.parametrize("cls,key", [("Gammatonegram", "trainable_bins"),
                                     ("ChromaSTFT", "trainable_chroma")])
def test_default_power_is_one_filterbank_launch(kernel_route, cls, key):
    """At power 2 the frozen transform is one K2 launch, on the FFT route (its
    basis is a frozen Fourier basis); nothing else."""
    _, tl = _pair(cls)
    with torch.no_grad():
        tl(_signal())
    assert kernel_route == {"framed_magnitude": 0, "framed_magnitude_kchunk": 0,
                            "framed_filterbank": 0, "framed_pair": 0,
                            "synthesis_ola": 0, "framed_filterbank_fft": 1,
                            "synthesis_ola_fft": 0, "gl_step_fft": 0}


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("cls,basis,flag", [
    ("Gammatonegram", "gammatone_basis", "trainable_bins"),
    ("ChromaSTFT", "chroma_basis", "trainable_chroma")])
def test_trainable_gradients_match_jax(request, route, cls, basis, flag):
    """The bank's and the STFT's gradients against jax.grad; on the card's
    route the forward under grad is the pair (K5) once, no K1, K2 or K6."""
    calls = request.getfixturevalue("kernel_route") if route == "kernel" else None
    kw = {flag: True, "trainable_STFT": True}
    if cls == "Gammatonegram":
        kw["n_bins"] = 24
    jl, tl = _pair(cls, **kw)
    x = _signal(4096, batch=1, seed=3)
    want = jax.grad(lambda p: jnp.sum(jl.apply(p, x) ** 2))(jl.trainable_params())
    assert set(want) == {basis, "wsin", "wcos"}
    (tl(x) ** 2).sum().backward()
    for k, g in want.items():
        _close(getattr(tl, k).grad, g)
    if calls is not None:
        assert calls["framed_pair"] == 1
        assert calls["framed_magnitude"] == calls["framed_filterbank"] == 0
        assert calls["framed_magnitude_kchunk"] == calls["framed_filterbank_fft"] == 0


@pytest.mark.parametrize("cls,kw", [("Gammatonegram", dict(trainable_bins=True)),
                                    ("ChromaSTFT", dict(trainable_STFT=True))])
def test_state_keys_and_jax_snapshot(cls, kw):
    """state_dict() keys are JAX's; a JAX snapshot (scaled, so it differs
    from the init) loads through load_jax_state and gives JAX's output."""
    jl, tl = _pair(cls, **kw)
    assert set(tl.state_dict()) == set(jl.state_dict())
    snap = {k: np.asarray(v) * 1.5 for k, v in jl.state_dict().items()}
    jl.load_state_dict(snap)
    load_jax_state(tl, snap)
    x = _signal(seed=4)
    with torch.no_grad():
        _close(tl(x), jl(jnp.asarray(x)))
