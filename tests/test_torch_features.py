"""The port's STFT, iSTFT, MelSpectrogram and MFCC against the JAX package's
on the same numpy inputs, on the CPU; and the FFT routes of transforms whose
tensors were moved."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch import fast_mode
from nnaudio_tpu_torch.interop import load_jax_state, params_from_jax
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

TOL = 1e-4   # framed ops (tests/test_ops.py)
RT_TOL = 1e-3  # round trips


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=tol, atol=tol), np.abs(got - want).max()


def _signal(sr=8000, seconds=0.5, batch=2, seed=0):
    return np.random.RandomState(seed).randn(batch, int(sr * seconds)).astype(np.float32)


STFT_CASES = [
    dict(n_fft=2048, hop_length=512),
    dict(n_fft=512, hop_length=160),
    dict(n_fft=512, hop_length=160, trainable=True),
    dict(n_fft=512, hop_length=128, freq_bins=96, freq_scale="log", fmin=50,
         fmax=4000, sr=8000),
]


@pytest.mark.parametrize("kw", STFT_CASES)
@pytest.mark.parametrize("fmt", ["Complex", "Magnitude", "Phase"])
def test_stft_matches_jax(kw, fmt):
    x = _signal()
    want = jf.STFT(verbose=False, output_format=fmt, **kw)(jnp.asarray(x))
    got = tf.STFT(verbose=False, output_format=fmt, device="cpu", **kw)(x)
    if fmt == "Phase":
        # compare as unit phasors (atan2 wraps at +-pi), on the bins whose
        # magnitude conditions the phase: at |X| -> 0 the phase is noise
        mag = np.asarray(jf.STFT(verbose=False, output_format="Magnitude", **kw)(jnp.asarray(x)))
        keep = mag > 1e-3 * mag.max()
        _close(np.cos(_np(got))[keep], np.cos(_np(want))[keep])
        _close(np.sin(_np(got))[keep], np.sin(_np(want))[keep])
    else:
        _close(got, want)


def test_stft_trainable_eps_under_sqrt():
    x = np.zeros((1, 4096), np.float32)
    mag = tf.STFT(n_fft=512, hop_length=128, trainable=True, verbose=False,
                  output_format="Magnitude", device="cpu")(x)
    assert torch.allclose(mag, torch.full_like(mag, 1e-4))


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 160)])
def test_inverse_round_trips_match_jax(n_fft, hop):
    x = _signal(seconds=0.75)
    length = x.shape[1]
    st_t = tf.STFT(n_fft=n_fft, hop_length=hop, iSTFT=True, verbose=False, device="cpu")
    st_j = jf.STFT(n_fft=n_fft, hop_length=hop, iSTFT=True, verbose=False)
    X = st_t(x)
    rec = st_t.inverse(X, length=length)
    _close(rec, x, RT_TOL)
    _close(rec, st_j.inverse(st_j(jnp.asarray(x)), length=length), RT_TOL)

    ist_t = tf.iSTFT(n_fft=n_fft, hop_length=hop, verbose=False, device="cpu")
    ist_j = jf.iSTFT(n_fft=n_fft, hop_length=hop, verbose=False)
    rec2 = ist_t(X, onesided=True, length=length)
    _close(rec2, x, RT_TOL)
    _close(rec2, ist_j(jnp.asarray(_np(X)), onesided=True, length=length), RT_TOL)
    # the full-spectrum default (onesided=False) and no length
    full = np.concatenate([_np(X), _np(X)[:, 1:-1][:, ::-1] * np.array([1, -1], np.float32)], 1)
    _close(ist_t(full), ist_j(jnp.asarray(full)), RT_TOL)


def test_istft_trainable_kernels_keep_mirror():
    x = _signal(seconds=0.5, batch=1)
    X = tf.STFT(n_fft=256, hop_length=64, verbose=False, device="cpu")(x)
    layer = tf.iSTFT(n_fft=256, hop_length=64, trainable_kernels=True,
                     verbose=False, device="cpu")
    rec = layer(X, onesided=True, length=x.shape[1])
    _close(rec, x, RT_TOL)
    rec.sum().backward()
    assert layer.kernel_cos.grad[-1].abs().sum() > 0  # upper-half rows train


@pytest.mark.parametrize("kw", [
    dict(sr=16000, n_fft=1024, hop_length=256, n_mels=64),
    dict(sr=8000, n_fft=512, hop_length=160, n_mels=40, trainable_STFT=True,
         trainable_mel=True),
    dict(sr=8000, n_fft=512, hop_length=128, n_mels=32, power=1.0),
])
def test_mel_and_mfcc_match_jax(kw):
    x = _signal()
    _close(tf.MelSpectrogram(verbose=False, device="cpu", **kw)(x),
           jf.MelSpectrogram(verbose=False, **kw)(jnp.asarray(x)))
    _close(tf.MFCC(verbose=False, device="cpu", n_mfcc=13, **kw)(x),
           jf.MFCC(verbose=False, n_mfcc=13, **kw)(jnp.asarray(x)))


def test_fast_mode_stays_near_fp32():
    x = _signal()
    mel = tf.MelSpectrogram(sr=8000, n_fft=512, hop_length=128, n_mels=32,
                            verbose=False, device="cpu")
    ref = mel(x)
    with fast_mode():
        fast = mel(x)
    err = float((fast - ref).abs().max() / ref.abs().max())
    assert 0 < err < 5e-2  # bf16 storage (tests/test_ops.py:215)


@pytest.mark.parametrize("make", [
    lambda m, d: m.STFT(n_fft=256, hop_length=64, verbose=False, **d),
    lambda m, d: m.STFT(n_fft=256, hop_length=64, iSTFT=True, trainable=True, verbose=False, **d),
    lambda m, d: m.iSTFT(n_fft=256, hop_length=64, trainable_window=True, verbose=False, **d),
    lambda m, d: m.MelSpectrogram(sr=8000, n_fft=256, hop_length=64, n_mels=16, verbose=False, **d),
    lambda m, d: m.MFCC(sr=8000, n_fft=256, hop_length=64, n_mels=16, verbose=False, **d),
])
def test_state_dict_keys_match_jax(make):
    t = make(tf, dict(device="cpu"))
    j = make(jf, {})
    assert set(t.state_dict()) == set(j.state_dict())
    assert set(t.trainable_params()) == set(j.trainable_params())
    for v in t.state_dict().values():
        assert v.dtype == torch.float32


def test_mel_shares_one_set_of_kernels():
    mel = tf.MelSpectrogram(sr=8000, n_fft=256, hop_length=64, n_mels=16,
                            trainable_STFT=True, verbose=False, device="cpu")
    assert mel.wsin is mel.stft.wsin and mel.wcos is mel.stft.wcos
    mfcc = tf.MFCC(sr=8000, n_fft=256, hop_length=64, n_mels=16, verbose=False,
                   device="cpu")
    assert mfcc.mel_basis is mfcc.melspec_layer.mel_basis


def test_perturbed_jax_state_reproduces_jax_output():
    """A JAX state_dict with perturbed values, carried across by interop,
    gives the JAX transform's output."""
    x = _signal()
    kw = dict(sr=8000, n_fft=512, hop_length=160, n_mels=40, trainable_mel=True,
              trainable_STFT=True, verbose=False)
    jm = jf.MelSpectrogram(**kw)
    rng = np.random.RandomState(11)
    state = {k: (v * (1 + 0.1 * rng.randn(*v.shape))).astype(np.float64)
             for k, v in jm.state_dict().items()}  # float64 on purpose
    jm.load_state_dict(state)
    tm = tf.MelSpectrogram(device="cpu", **kw)
    load_jax_state(tm, state)
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())
    want = jm(jnp.asarray(x))
    _close(tm(x), want)
    # the functional form takes the same state as an override
    fresh = tf.MelSpectrogram(device="cpu", **kw)
    _close(fresh.apply(params_from_jax(state, "cpu"), x), want)
    with pytest.raises(RuntimeError):
        load_jax_state(tm, {k: v for k, v in state.items() if k != "wsin"})


MOVED_KW = dict(sr=8000, n_fft=256, hop_length=64, verbose=False, device="cpu")


@pytest.mark.parametrize("name,launches", [
    ("MelSpectrogram", {"framed_filterbank_fft": 1}),
    ("MFCC", {"framed_filterbank_fft": 1}),
    ("Gammatonegram", {"framed_filterbank_fft": 1}),
    ("ChromaSTFT", {"framed_filterbank_fft": 1}),
    ("InverseMelSpectrogram", {"synthesis_ola_fft": 3, "gl_step_fft": 2}),
])
def test_a_moved_transform_keeps_its_fft_route(kernel_route, name, launches):
    """``Module.to(device)`` puts a new tensor in place of each of a
    transform's own (``m._apply(lambda t: t.clone())`` does what ``.to``
    does to each one). The transforms that keep an inner one apart from
    their state (an STFT, a Griffin-Lim) read the new tensors, which are
    still their own: K2's, K3's and K4's FFT routes stay, on the same
    values."""
    if name == "InverseMelSpectrogram":
        layer = tf.InverseMelSpectrogram(n_mels=16, n_iter=2, n_iter_nnls=4,
                                         iter_precision="highest", **MOVED_KW)
        x = torch.rand(2, 16, 12, generator=torch.Generator().manual_seed(8))
        kw = dict(rand_phase=torch.rand(2, 129, 12, generator=torch.Generator().manual_seed(9)))
    else:
        layer = getattr(tf, name)(**MOVED_KW)
        x, kw = torch.from_numpy(_signal(seconds=0.25)), {}
    with torch.no_grad():
        want = layer(x, **kw)
        old = {k: v.data_ptr() for k, v in layer.params.items()}
        layer._apply(lambda t: t.clone())
        assert all(v.data_ptr() != old[k] for k, v in layer.params.items())
        for k in kernel_route:
            kernel_route[k] = 0
        got = layer(x, **kw)
    assert kernel_route == {k: launches.get(k, 0) for k in kernel_route}
    assert torch.equal(got, want)
