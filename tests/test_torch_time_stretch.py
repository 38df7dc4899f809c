"""The port's phase vocoder, TimeStretch, resample_poly / resample and
PitchShift against the JAX package's and against fp64 oracles, on the CPU.

Vocoder outputs are compared as complex stacks (never as phases: ``atan2``
differs at the +-pi cut, and a wrap that rounds the other way moves a phase
by 2 pi, which the stack does not see). The unlocked vocoder is held against
the fp64 replica of librosa's loop of tests/test_time_stretch.py at its
tolerance (99.9% of the elements within 2e-3 of max |ref|, all within
0.05), and so is every vocoder output against JAX's: the accumulated phase
of a high bin reaches 1e4 rad, where one fp32 ulp is 1e-3 rad, and the two
packages sum it in different orders. ``resample_poly`` is held against
scipy within ``2e-6 * max|ref|`` (tests/test_time_stretch.py:135).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu.features.time_stretch import _nearest_peak_index as j_peaks
from nnaudio_tpu.features.time_stretch import phase_vocoder as j_vocoder
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.core.resample import resample_poly
from nnaudio_tpu_torch.features.time_stretch import _nearest_peak_index
from test_time_stretch import _librosa_loop
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

SR = 22050


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _vocoder_close(got, want):
    """99.9% of the elements within 2e-3 of max |ref|, all within 0.05."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    assert (err > 2e-3 * np.abs(want).max()).mean() < 1e-3
    assert err.max() < 0.05 * np.abs(want).max()


def _tone(freq=440.0, secs=1.0):
    t = np.arange(int(SR * secs)) / SR
    return np.sin(2 * np.pi * freq * t).astype(np.float32)[None]


def _stft_complex(seed=3, n=SR // 2):
    st = tf.STFT(n_fft=1024, hop_length=256, output_format="Complex",
                 verbose=False, device="cpu")
    x = np.random.RandomState(seed).randn(1, n).astype(np.float32)
    with torch.no_grad():
        return st(x)


# ----------------------------------------------------------------- vocoder --
@pytest.mark.parametrize("rate", [0.8, 1.0, 1.3])
def test_unlocked_vocoder_matches_librosa_loop_and_jax(rate):
    X = _stft_complex()
    got = _np(tf.phase_vocoder(X, rate, 256, phase_lock=False))
    D = X[0, :, :, 0].double().numpy() + 1j * X[0, :, :, 1].double().numpy()
    want = _librosa_loop(D, rate, 256)
    want = np.stack([want.real, want.imag], -1)[None]
    assert got.shape == want.shape
    _vocoder_close(got, want)
    _vocoder_close(got, j_vocoder(jnp.asarray(X.numpy()), rate, 256, phase_lock=False))


@pytest.mark.parametrize("rate", [0.5, 0.8, 1.25, 2.0])
def test_locked_vocoder_matches_jax(rate):
    X = _stft_complex(seed=4)
    got = tf.phase_vocoder(X, rate, 256)
    want = np.asarray(j_vocoder(jnp.asarray(X.numpy()), rate, 256))
    assert got.shape == (1, 513, int(np.ceil(X.shape[2] / rate)), 2)
    _vocoder_close(got, want)


def test_vocoder_takes_arrays_and_stays_on_the_input_device():
    """A tensor is worked on where it lies; an array goes to ``device=``."""
    X = _stft_complex(seed=5)
    a = tf.phase_vocoder(X.numpy(), 0.8, 256, device="cpu")
    b = tf.phase_vocoder(X, 0.8, 256)
    assert a.device == b.device == X.device and torch.equal(a, b)


def test_nearest_peak_index_matches_jax_ties_to_the_lower_bin():
    """Plateaus and equal distances: the lower bin wins, as in JAX."""
    rng = np.random.RandomState(6)
    mag = rng.randint(0, 4, size=(2, 40, 7)).astype(np.float32)
    mag[0, :, 0] = 1.0  # all flat: every bin is a peak
    # peaks at bins 10 and 14 only, bin 12 halfway between them
    b = np.arange(40)
    mag[0, :, 1] = np.maximum(5 - np.abs(b - 10), 5 - np.abs(b - 14))
    idx, peaks = _nearest_peak_index(torch.from_numpy(mag))
    jidx, jpeaks = j_peaks(jnp.asarray(mag))
    assert np.array_equal(_np(idx), np.asarray(jidx))
    assert np.array_equal(_np(peaks), np.asarray(jpeaks))
    assert int(idx[0, 12, 1]) == 10


# ------------------------------------------------------------ TimeStretch --
@pytest.mark.parametrize("rate", [0.5, 0.8, 1.25])
def test_locked_stretch_matches_jax_and_keeps_amplitude_and_pitch(rate):
    x = _tone(440.0)
    y = tf.TimeStretch(n_fft=1024, hop_length=256, device="cpu")(x, rate=rate)
    assert y.shape[-1] == int(round(x.shape[-1] / rate))
    _vocoder_close(y, jf.TimeStretch(n_fft=1024, hop_length=256)(x, rate=rate))
    core = slice(2048, y.shape[-1] - 2048)
    rms = float(y[:, core].square().mean().sqrt())
    assert abs(rms - 0.707) < 0.05, rms
    st = tf.STFT(n_fft=4096, hop_length=1024, output_format="Magnitude",
                 verbose=False, device="cpu")
    freq = int(st(y).mean(-1)[0].argmax()) * SR / 4096
    assert abs(freq - 440.0) < SR / 4096 * 1.5, freq


def _kernel_arithmetic(monkeypatch):
    """Every wrapper takes its CUDA branch, and K5 and K3 compute their fp32
    arithmetic in place of a launch: the 3xTF32 twins of the tensor-core
    kernels, and K3's FFT route (the iSTFT's frozen Fourier basis) its twin."""
    from nnaudio_tpu_torch.ops import framed_kernels as fk
    monkeypatch.setattr(fk, "_on_card", lambda t: True)
    monkeypatch.setattr(fk, "_launch_pair", fk.framed_pair_3xtf32_plain)
    monkeypatch.setattr(fk, "_launch_synthesis", fk.synthesis_ola_3xtf32_plain)
    monkeypatch.setattr(fk, "_launch_synthesis_fft", lambda sre, sim, hop, plan:
                        fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop))


@pytest.mark.parametrize("rate", [0.8, 2.0 ** (-7 / 12)])
def test_stretch_through_the_kernels_arithmetic_keeps_the_magnitude(rate, monkeypatch):
    """A tone with overtones and a sweep, stretched with K5's and K3's fp32
    arithmetic against the plain route. The vocoder magnifies the routes'
    small STFT differences in the waveform (its peak picking and phases);
    the output's STFT magnitude stays within 1e-3 by spectral convergence,
    the limit chip_smoke.py's path (r) holds on the card."""
    rng = np.random.RandomState(11)
    t = np.arange(3 * SR) / SR
    x = sum(np.sin(2 * np.pi * k * 220.0 * t + rng.uniform(0, 2 * np.pi)) / k
            for k in range(1, 5))
    x = x + 0.5 * np.sin(2 * np.pi * (300 * t + 800 * t * t))
    x = torch.from_numpy((x / 2).astype(np.float32))[None]
    ts = tf.TimeStretch(n_fft=1024, hop_length=256, device="cpu")
    mag = tf.STFT(n_fft=1024, hop_length=256, output_format="Magnitude",
                  verbose=False, device="cpu")
    with torch.no_grad():
        want = ts(x, rate=rate)
        with monkeypatch.context() as m:
            _kernel_arithmetic(m)
            got = ts(x, rate=rate)
        assert not torch.equal(got, want)
        a, b = mag(got), mag(want)
    assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-3


def test_unlocked_stretch_matches_jax():
    x = np.random.RandomState(7).randn(2, SR // 2).astype(np.float32)
    got = tf.TimeStretch(n_fft=512, hop_length=128, device="cpu")(x, 0.9, phase_lock=False)
    _vocoder_close(got, jf.TimeStretch(n_fft=512, hop_length=128)(x, 0.9, phase_lock=False))


def test_rate_one_is_identity():
    x = _tone(523.25)
    y = _np(tf.TimeStretch(n_fft=1024, hop_length=256, device="cpu")(x, rate=1.0))
    core = slice(2048, x.shape[-1] - 2048)
    err = y[:, core] - x[:, core]
    assert 10 * np.log10((x[:, core] ** 2).sum() / (err ** 2).sum()) > 40


def test_time_stretch_validates_rate_and_pads_the_shortfall():
    ts = tf.TimeStretch(n_fft=512, hop_length=512, device="cpu")
    with pytest.raises(ValueError):
        ts(np.zeros(4096, np.float32), rate=0.0)
    y = ts(_tone(440.0, secs=8192 / SR)[:, :8192], rate=6.0)
    assert y.shape == (1, round(8192 / 6.0)) and torch.isfinite(y).all()


def test_time_stretch_launches(kernel_route):
    """On the card's route: the STFT's pair (K5) once, the iSTFT's synthesis
    (K3, on its FFT route: the iSTFT's frozen Fourier basis) once."""
    ts = tf.TimeStretch(n_fft=1024, hop_length=256, device="cpu")
    with torch.no_grad():
        ts(_tone(secs=0.5), rate=0.8)
    assert kernel_route == {"framed_magnitude": 0, "framed_magnitude_kchunk": 0,
                            "framed_filterbank": 0, "framed_pair": 1,
                            "synthesis_ola": 0, "framed_filterbank_fft": 0,
                            "synthesis_ola_fft": 1, "gl_step_fft": 0}


# --------------------------------------------------------------- resample --
@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (160, 147), (320, 441),
                                     (1, 4), (4, 1), (5, 5)])
def test_resample_poly_matches_scipy(up, down):
    from scipy import signal

    x = np.random.RandomState(0).randn(2, 4321).astype(np.float32)
    want = signal.resample_poly(x.astype(np.float64), up, down, axis=1,
                                window=("kaiser", 5.0))
    got = _np(resample_poly(torch.from_numpy(x), up, down))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_resample_matches_jax_and_keeps_the_tone():
    x = _tone(440.0)
    y = tf.resample(torch.from_numpy(x), SR, 16000)
    assert y.shape[-1] == 16000
    assert _rel(y, jf.resample(x, SR, 16000)) <= 1e-5
    spec = np.abs(np.fft.rfft(_np(y)[0] * np.hanning(16000)))
    assert abs(spec.argmax() * 16000 / 16000 - 440.0) < 2.0
    one = tf.resample(x[0], SR, 44100, device="cpu")  # 1-D in, 1-D out, from an array
    assert one.ndim == 1 and one.shape[0] == 2 * x.shape[-1]


def test_resample_poly_gradient_reaches_the_signal():
    x = torch.randn(1, 2000, requires_grad=True)
    resample_poly(x, 2, 3).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ------------------------------------------------------------- PitchShift --
@pytest.mark.parametrize("n_steps", [12, 7, -5, 3.5])
def test_pitch_shift_matches_jax_frequency_and_length(n_steps):
    x = _tone(440.0)
    y = tf.PitchShift(sr=SR, n_fft=1024, hop_length=256, device="cpu")(x, n_steps)
    assert y.shape == x.shape
    _vocoder_close(y, jf.PitchShift(sr=SR, n_fft=1024, hop_length=256)(x, n_steps=n_steps))
    st = tf.STFT(n_fft=8192, hop_length=2048, output_format="Magnitude",
                 verbose=False, device="cpu")
    freq = int(st(y).mean(-1)[0].argmax()) * SR / 8192
    assert abs(freq - 440.0 * 2 ** (n_steps / 12)) < SR / 8192 * 1.5


def test_pitch_shift_zero_steps_and_1d_shapes():
    x = _tone(440.0, secs=0.5)[0]
    ps = tf.PitchShift(sr=SR, n_fft=1024, hop_length=256, device="cpu")
    assert np.array_equal(_np(ps(x, n_steps=0)), x)
    z = ps(x, n_steps=3)
    assert z.ndim == 1 and z.shape[0] == x.shape[0]
    ts = tf.TimeStretch(n_fft=1024, hop_length=256, device="cpu")
    y = ts(x, rate=0.8)
    assert y.ndim == 1 and y.shape[0] == round(x.shape[0] / 0.8)


# ----------------------------------------------------- the device= rule --
def test_new_entry_points_refuse_the_cpu_without_a_device_argument():
    """Without CUDA, every entry point of this slice raises unless it is
    given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    for make in (lambda: tf.Gammatonegram(verbose=False),
                 lambda: tf.ChromaSTFT(verbose=False),
                 lambda: tf.GriffinLimCQT(verbose=False),
                 lambda: tf.GriffinLimCQT(family="2010v2", verbose=False),
                 lambda: tf.GriffinLimCQT(family="vqt", verbose=False),
                 lambda: tf.CFP(), lambda: tf.Combined_Frequency_Periodicity(),
                 lambda: tf.TimeStretch(), lambda: tf.PitchShift(),
                 lambda: tf.phase_vocoder(np.zeros((1, 5, 4, 2), np.float32), 0.8, 2),
                 lambda: tf.resample(np.zeros(100, np.float32), SR, 16000)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
