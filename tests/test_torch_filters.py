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


Q12 = 1.0 / (2 ** (1 / 12) - 1)


@pytest.mark.parametrize("args,kw", [
    ((Q12, 22050, 32.70, 84, 12, 1, "hann", None), dict()),
    ((16.8, 22050, 55, 24, 12), dict()),
    ((Q12, 8000, 100, 24, 12, 1, ("gaussian", 50)), dict()),
    ((Q12 / 2, 16000, 55, 48, 24, 2, "hamming"), dict()),
    ((Q12, 22050, 55, None, 12, 1, "hann", 880.0), dict()),
    ((Q12, 22050, 2093.0, 12, 12), dict(norm=1, topbin_check=False, gamma=2)),
    ((Q12, 5512.5, 2093.0, 12, 12), dict(norm=1, topbin_check=False)),
])
def test_cqt_kernels_identical(args, kw):
    from nnaudio_tpu.filters import cqt as jcqt
    from nnaudio_tpu_torch.filters import cqt as tcqt

    a = jcqt.create_cqt_kernels(*args, **kw)
    b = tcqt.create_cqt_kernels(*args, **kw)
    assert b.kernels.dtype == np.complex64 and a.fft_len == b.fft_len
    for name in ("kernels", "lengths", "freqs"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_cqt_nyquist_check_raises():
    from nnaudio_tpu_torch.filters import create_cqt_kernels

    with pytest.raises(ValueError, match="Nyquist"):
        create_cqt_kernels(Q12, 22050, 220, 84, 12, 1, "hann", None)


@pytest.mark.parametrize("args", [(0.5, 256, 0.001), (0.25, 256, 0.03),
                                  (0.5, 64, 0.1)])
def test_lowpass_filter_identical(args):
    from nnaudio_tpu.filters import cqt as jcqt
    from nnaudio_tpu_torch.filters import cqt as tcqt

    a, b = jcqt.create_lowpass_filter(*args), tcqt.create_lowpass_filter(*args)
    assert b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("args", [
    (22050, 512, 3951.0, Q12, 7),   # the default pyramid: no early downsampling
    (22050, 512, 500.0, Q12, 3),    # a low top bin and a generous hop: active
    (44100, 512, 1661.2, Q12, 4),
    (22050, 768, 500.0, Q12, 3),    # a hop where ceil and floor log2 differ
])
def test_early_downsample_params_identical(args):
    from nnaudio_tpu.filters import cqt as jcqt
    from nnaudio_tpu_torch.filters import cqt as tcqt

    a, b = jcqt.early_downsample_params(*args), tcqt.early_downsample_params(*args)
    assert a[:3] == b[:3] and a[4] == b[4]
    assert (a[3] is None and b[3] is None) or np.array_equal(a[3], b[3])
    assert jcqt.next_pow2_exponent(args[1]) == tcqt.next_pow2_exponent(args[1])


def test_filters_export_the_same_cqt_names():
    import nnaudio_tpu.filters as jfilters
    import nnaudio_tpu_torch.filters as tfilters
    from nnaudio_tpu.filters import cqt as jcqt

    names = {n for n in jfilters.__all__ if getattr(jfilters, n).__module__ == jcqt.__name__}
    assert names == {"CQTKernelBank", "cqt_frequencies", "create_cqt_kernels",
                     "create_lowpass_filter", "early_downsample_count",
                     "early_downsample_params", "next_pow2_exponent"}
    assert names <= set(tfilters.__all__)
    assert all(getattr(tfilters, n).__module__ == "nnaudio_tpu_torch.filters.cqt"
               for n in names)
