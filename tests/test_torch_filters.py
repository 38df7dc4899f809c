"""The port's numpy builders are exact copies of the JAX package's."""
import numpy as np
import pytest

from nnaudio_tpu.filters import fourier as jfourier
from nnaudio_tpu.filters import mel as jmel
from nnaudio_tpu.filters import windows as jwindows
from nnaudio_tpu_torch.filters import fourier as tfourier
from nnaudio_tpu_torch.filters import mel as tmel
from nnaudio_tpu_torch.filters import windows as twindows


@pytest.mark.parametrize("n_fft,kw", [
    (64, dict(window="ones")),
    (2048, dict()),
    (512, dict(win_length=400, window="hamming")),
    (1024, dict(freq_bins=128, freq_scale="linear", fmin=50, fmax=6000, sr=22050)),
    (1024, dict(freq_bins=128, freq_scale="log", fmin=50, fmax=6000, sr=22050)),
    (1024, dict(freq_bins=128, freq_scale="log2", fmin=50, fmax=6000, sr=22050)),
    (256, dict(window=("gaussian", 60.0))),
])
def test_fourier_basis_identical(n_fft, kw):
    a = jfourier.create_fourier_basis(n_fft, **kw)
    b = tfourier.create_fourier_basis(n_fft, **kw)
    for name in ("wsin", "wcos", "window_mask"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(b, name).dtype == np.float32
    assert a.bins2freq == b.bins2freq and a.binslist == b.binslist


@pytest.mark.parametrize("window", ["hann", ("gaussian", 60.0), 8.6])
def test_window_dispatch_identical(window):
    assert np.array_equal(jwindows.window_dispatch(window, 64),
                          twindows.window_dispatch(window, 64))
    assert np.array_equal(jwindows.pad_center(np.ones(10), 16),
                          twindows.pad_center(np.ones(10), 16))


@pytest.mark.parametrize("sr,n_fft,n_mels,kw", [
    (22050, 2048, 128, dict()),
    (16000, 1024, 64, dict()),
    (16000, 512, 40, dict(htk=True, fmin=20.0, fmax=7600.0)),
    (22050, 1024, 64, dict(norm=None)),
])
def test_mel_filterbank_identical(sr, n_fft, n_mels, kw):
    a = jmel.mel_filterbank(sr, n_fft, n_mels, **kw)
    b = tmel.mel_filterbank(sr, n_fft, n_mels, **kw)
    assert b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("n", [20, 64, 128])
def test_dct_matrix_identical(n):
    assert np.array_equal(jmel.dct_matrix(n, n), tmel.dct_matrix(n, n))
