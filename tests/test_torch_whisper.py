"""WhisperLogMel, Whisper's log-Mel front end, on the CPU: against the JAX
package's MelSpectrogram with the epilogue in numpy, against the benchmark's
plain reference, and against openai's ``log_mel_spectrogram`` written with
``torch.stft`` in float64; its frame count, its per-clip floor, its state and
the route its calls take."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bench_port.reference import builders
from bench_port.reference import whisper128_16k as reference
from nnaudio_tpu import features as jf
from nnaudio_tpu_torch import fast_mode
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.ops import framed_kernels as fk
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

#: Whisper's constants (openai's whisper/audio.py)
SR, N_FFT, HOP = 16000, 400, 160
SETTINGS = {"sr": SR, "n_fft": N_FFT, "hop_length": HOP, "n_mels": 128, "window": "hann",
            "pad_mode": "reflect", "htk": False, "fmin": 0.0, "fmax": 8000.0, "norm": 1,
            "amin": 1e-10, "log_floor": 8.0}


def _audio(batch=2, seconds=0.5, seed=0, scale=None):
    x = np.random.RandomState(seed).randn(batch, int(SR * seconds)).astype(np.float32)
    return x * np.asarray(scale, np.float32)[:, None] if scale is not None else x


def _epilogue(mel):
    """openai's epilogue in numpy, the floor per clip: the last frame
    dropped, log10 of the power clamped at 1e-10, the clip's max less 8,
    (x + 4) / 4."""
    log_spec = np.log10(np.maximum(np.asarray(mel, np.float64)[..., :-1], 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def _openai64(x, n_mels=128):
    """openai's log_mel_spectrogram in float64, each clip floored by its own
    max: torch.stft (centred, reflect), a periodic Hann window, |X|^2 of all
    frames but the last, the Slaney filters, log10, max - 8, (x + 4) / 4."""
    audio = torch.from_numpy(np.asarray(x, np.float64))
    stft = torch.stft(audio, N_FFT, HOP, window=torch.hann_window(N_FFT, dtype=torch.float64),
                      return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(builders.mel_filterbank(SR, N_FFT, n_mels, 0.0, 8000.0))
    log_spec = torch.clamp(filters @ magnitudes, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n_mels", [128, 80])
def test_whisper_log_mel_matches_jax_mel_and_the_epilogue(n_mels):
    """At 1e-4, the framed ops' tolerance: the JAX package has no Whisper
    front end, so its MelSpectrogram at Whisper's settings, then openai's
    epilogue in numpy."""
    x = _audio()
    got = tf.WhisperLogMel(n_mels=n_mels, device="cpu")(x)
    mel = jf.MelSpectrogram(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=n_mels, fmax=8000.0,
                            verbose=False)(jnp.asarray(x))
    want = _epilogue(mel)
    assert got.shape == want.shape == (2, n_mels, 50)
    assert np.allclose(got.numpy(), want, rtol=1e-4, atol=1e-4), np.abs(got.numpy() - want).max()


def test_whisper_log_mel_matches_the_benchmarks_plain_reference():
    """The reference is float32 too (dense products with TF32 off): the two
    part by fp32 rounding, 1e-6 relative at most; TF32 (the control) parts
    by far more."""
    x = torch.from_numpy(_audio(batch=3, seconds=1.0, seed=1))
    got = tf.WhisperLogMel(device="cpu")(x)
    want = reference.offline(SETTINGS, x)
    assert got.shape == want.shape == (3, 128, 100)
    assert _rel(got, want) <= 1e-6
    assert _rel(reference.offline(SETTINGS, x, control=True), want) > 1e-5


@pytest.mark.parametrize("seed", [2, 3])
def test_whisper_log_mel_matches_openais_formula_in_float64(seed):
    """Against openai's own steps in float64 on seeded noise: fp32's
    rounding of the power, 1e-7 of each frame's, moves a log10 by ~1e-7 / 4
    away from the floor; 1e-5 of the largest entry holds everywhere."""
    x = _audio(batch=2, seconds=0.75, seed=seed, scale=[1.0, 0.01])
    got = tf.WhisperLogMel(device="cpu")(x).numpy()
    want = _openai64(x)
    assert got.shape == want.shape == (2, 128, 75)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_a_30_s_window_gives_3000_frames():
    x = torch.from_numpy(_audio(batch=1, seconds=30.0, seed=4))
    assert x.shape[1] == 480_000
    assert tf.WhisperLogMel(device="cpu")(x).shape == (1, 128, 3000)
    assert tf.WhisperLogMel(device="cpu")(x[0]).shape == (1, 128, 3000)


def test_a_clips_answer_does_not_change_with_its_batchmates():
    """The floor is each clip's own max less 8: a loud batchmate (x 1000,
    60 dB up) would lift a batch-wide floor over most of a quiet clip."""
    x = torch.from_numpy(_audio(batch=3, seconds=0.5, seed=5, scale=[1.0, 1000.0, 0.001]))
    layer = tf.WhisperLogMel(device="cpu")
    together = layer(x)
    for i in range(3):
        alone = layer(x[i:i + 1])
        assert _rel(together[i:i + 1], alone) <= 1e-6
    mel = layer.melspec_layer(x)[..., :-1]
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    batch_wide = torch.maximum(db, db.max() - 80.0) / 40.0 + 1.0
    assert _rel(batch_wide[2:], together[2:]) > 0.1


def test_the_state_is_the_held_mels_flat_keys():
    layer = tf.WhisperLogMel(device="cpu")
    assert list(layer.state_dict()) == ["wsin", "wcos", "mel_basis"]
    assert layer.wcos is layer.melspec_layer.wcos
    assert tuple(layer.mel_basis.shape) == (128, 201)
    other = tf.WhisperLogMel(device="cpu")
    other.load_state_dict(layer.state_dict())
    x = torch.from_numpy(_audio(seed=6))
    assert torch.equal(other(x), layer(x))


def test_a_call_takes_k2s_fft_route_and_fast_mode_dense_k2(kernel_route):
    layer = tf.WhisperLogMel(device="cpu")
    x = torch.from_numpy(_audio(seed=7))
    with torch.no_grad():
        got = layer(x)
        assert kernel_route["framed_filterbank_fft"] == 1
        assert kernel_route["framed_filterbank"] == 0
        assert _rel(got, reference.offline(SETTINGS, x)) <= 1e-6
        with fast_mode():
            layer(x)
    assert kernel_route["framed_filterbank"] == 1
    assert fk.fft_plan(layer.wcos, layer.wsin, layer.mel_basis) is not None
