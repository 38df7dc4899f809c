"""The port's CQT/VQT family (CQT1992, CQT1992v2, CQT, CQT2010, CQT2010v2,
VQT and the flat ``.inverse``) against the JAX package's on the same numpy
inputs, on the CPU. fp32 tolerance 1e-4 of max |ref| unless stated."""
import os
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.features.cqt import (_center_pad, _dual_synthesis_bank,
                                            _warn_undersampled_hop)
from nnaudio_tpu_torch.interop import load_jax_state
from nnaudio_tpu_torch.ops import framed_kernels as fk

TOL = 1e-4
FORMATS = ["Magnitude", "Complex", "Phase"]
NORMS = ["librosa", "convolutional", "wrap"]
#: a small flat bank (tests/test_inverse_cqt.py): 24 wavelets of 2048 samples
SMALL = dict(sr=8000, fmin=100, n_bins=24, bins_per_octave=12, hop_length=64)
#: a small pyramid: 3 octaves
PYRAMID = dict(sr=8000, fmin=110, n_bins=30, bins_per_octave=12, hop_length=64)
ORACLES = os.path.join(os.path.dirname(__file__), "ground-truths",
                       "reference_oracles.npz")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _signal(n=8000, batch=2, seed=0):
    return np.random.RandomState(seed).randn(batch, n).astype(np.float32)


def _tones(sr=22050, secs=1.0, freqs=(110, 220, 440, 523.25, 660)):
    t = np.arange(int(sr * secs)) / sr
    return sum(np.sin(2 * np.pi * f * t + i)
               for i, f in enumerate(freqs)).astype(np.float32)[None]


def _pair(name, verbose=True, **kw):
    """The JAX transform and the port's, from the same arguments."""
    extra = dict(verbose=False) if verbose else {}
    return (getattr(jf, name)(**kw, **extra),
            getattr(tf, name)(**kw, **extra, device="cpu"))


def _compare(jl, tl, x, fmt, norm, tol=TOL):
    want = jl(jnp.asarray(x), output_format=fmt, normalization_type=norm)
    got = tl(x, output_format=fmt, normalization_type=norm)
    if fmt == "Phase":
        # (cos, sin) of a bin is conditioned by its magnitude: at |X| -> 0 the
        # phase is rounding noise in both packages
        mag = _np(jl(jnp.asarray(x), output_format="Magnitude",
                     normalization_type="convolutional"))
        keep = mag > 1e-3 * mag.max()
        assert got.shape == want.shape
        _close(_np(got)[keep], _np(want)[keep], tol)
    else:
        _close(got, want, tol)


# ------------------------------------------------------------- CQT1992v2 --
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_cqt1992v2_matches_jax(fmt, norm):
    jl, tl = _pair("CQT1992v2", **SMALL)
    _compare(jl, tl, _signal(), fmt, norm)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kw", [
    dict(center=False),
    dict(window=("gaussian", 50)),
    dict(fmax=1500.0),
    dict(pad_mode="constant"),
    dict(filter_scale=0.5, norm=2),
    dict(trainable=True),
], ids=lambda kw: "-".join(kw))
def test_cqt1992v2_options_match_jax(kw, fmt):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SyntaxWarning)  # fmax overrides n_bins
        jl, tl = _pair("CQT1992v2", **{**SMALL, **kw})
    _compare(jl, tl, _signal(seed=1), fmt, "librosa")


def test_cqt1992v2_default_bank_on_one_second():
    """The default 84 x 16384 bank: on CUDA tensors this shape goes to K6."""
    jl, tl = _pair("CQT1992v2")
    assert tuple(tl.cqt_kernels_real.shape) == (84, 16384)
    x = _signal(22050, batch=1, seed=2)
    before = dict(fk.LAUNCHES)
    for fmt in FORMATS:
        _compare(jl, tl, x, fmt, "librosa")
    assert fk.LAUNCHES == before  # CPU tensors launch nothing


def test_cqt1992v2_short_signal_falls_back_to_constant_padding():
    jl, tl = _pair("CQT1992v2", **SMALL)
    x = _signal(500)  # shorter than kernel_width // 2 + 1 = 1025
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jl(jnp.asarray(x))
    with pytest.warns(UserWarning, match="constant padding"):
        got = tl(x)
    _close(got, want)
    with pytest.warns(UserWarning):
        assert _center_pad(torch.zeros(1, 0), 4, "reflect").shape == (1, 8)


def test_cqt1992v2_forward_manual_and_call_forms():
    jl, tl = _pair("CQT1992v2", **SMALL)
    x = _signal(seed=3)
    _close(tl.forward_manual(x), jl.forward_manual(jnp.asarray(x)))
    # 1-D and (B, 1, L) inputs, the functional form, the per-call override
    _close(tl(x[0]), jl(jnp.asarray(x[0])))
    _close(tl(x[:, None, :]), jl(jnp.asarray(x)))
    _close(tl.apply(None, x, output_format="Complex"),
           jl(jnp.asarray(x), output_format="Complex"))
    with pytest.raises(ValueError, match="normalization_type"):
        tl(x, normalization_type="bogus")
    with pytest.raises(ValueError, match="output_format"):
        tl(x, output_format="Power")


def test_cqt_alias_and_normalization_scales():
    assert tf.CQT is not tf.CQT1992v2 and issubclass(tf.CQT, tf.CQT1992v2)
    layer = tf.CQT(**SMALL, verbose=False, device="cpu")
    x = _signal(seed=4)
    conv = layer(x, normalization_type="convolutional")
    lengths = layer.lenghts
    assert torch.allclose(layer(x), conv * torch.sqrt(lengths)[None, :, None],
                          rtol=1e-5, atol=1e-6)
    assert torch.allclose(layer(x, normalization_type="wrap"), conv * 2)


@pytest.fixture(scope="module")
def oracles():
    if not os.path.exists(ORACLES):
        pytest.skip("frozen oracles not generated")
    with np.load(ORACLES) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,key,kw", [
    ("CQT1992v2", "cqt1992v2_48", dict(fmin=55, n_bins=48, verbose=False)),
    ("CQT1992", "cqt1992_40", dict(fmin=220, n_bins=40)),
    ("CQT2010v2", "cqt2010v2_48", dict(fmin=55, n_bins=48, verbose=False)),
    ("CQT2010", "cqt2010_48", dict(fmin=55, n_bins=48, verbose=False)),
    ("VQT", "vqt_g2_48", dict(fmin=55, n_bins=48, gamma=2, verbose=False)),
    ("VQT", "vqt_g5_48", dict(fmin=55, n_bins=48, gamma=5, verbose=False)),
])
def test_frozen_nnaudio_oracles(oracles, name, key, kw):
    """The frozen outputs of nnAudio that tests/test_frozen_oracles.py holds
    the JAX package to, at that test's tolerance."""
    if key not in oracles:
        pytest.skip("oracle not frozen")
    layer = getattr(tf, name)(sr=16000, bins_per_octave=12, hop_length=256,
                              device="cpu", **kw)
    out = _np(layer(oracles["input"][None], output_format="Complex"))
    want = oracles[key]
    assert out.shape == want.shape
    assert np.abs(out - want).max() / max(np.abs(want).max(), 1e-3) < 2e-3


@pytest.mark.parametrize("sweep", ["log", "linear"])
def test_cqt1992v2_vs_sweep_ground_truth(ground_truth_dir, chirp_signals, sweep):
    """nnAudio's chirp-sweep ground truths, at tests/test_cqt.py's tolerances."""
    x = chirp_signals[sweep][None]
    layer = tf.CQT1992v2(sr=chirp_signals["fs"], fmin=55, n_bins=207,
                         bins_per_octave=24, verbose=False, device="cpu")
    cplx = _np(layer(x, output_format="Complex"))
    gt_c = np.load(f"{ground_truth_dir}/{sweep}-sweep-cqt-1992-complex-ground-truth.npy")
    assert np.allclose(cplx, gt_c, rtol=1e-3, atol=1e-3)
    mag = _np(layer(x, output_format="Magnitude"))
    gt_m = np.load(f"{ground_truth_dir}/{sweep}-sweep-cqt-1992-mag-ground-truth.npy")
    gt_m = gt_m.reshape(mag.shape)
    gt_lin = np.exp(gt_m) - 1e-5
    mask = gt_lin > 1e-3 * gt_lin.max()
    assert np.allclose(np.log(mag + 1e-5)[mask], gt_m[mask], rtol=1e-3, atol=2e-3)
    phase = _np(layer(x, output_format="Phase"))
    gt_p = np.load(f"{ground_truth_dir}/{sweep}-sweep-cqt-1992-phase-ground-truth.npy")
    keep = np.broadcast_to(gt_lin[..., None], gt_p.shape) > 1e-3 * gt_lin.max()
    assert np.abs(phase - gt_p)[keep].max() < 5e-3


@pytest.mark.parametrize("sweep", ["log", "linear"])
def test_cqt2010v2_vs_sweep_ground_truth(ground_truth_dir, chirp_signals, sweep):
    x = chirp_signals[sweep][None]
    layer = tf.CQT2010v2(sr=chirp_signals["fs"], fmin=55, n_bins=207,
                         bins_per_octave=24, verbose=False, device="cpu")
    cplx = _np(layer(x, output_format="Complex"))
    gt_c = np.load(f"{ground_truth_dir}/{sweep}-sweep-cqt-2010-complex-ground-truth.npy")
    assert np.allclose(cplx, gt_c, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------- CQT1992 --
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kw", [
    dict(), dict(trainable_STFT=True), dict(trainable_CQT=True),
    dict(center=False, window="hamming"),
], ids=lambda kw: "-".join(kw) or "frozen")
def test_cqt1992_matches_jax(kw, fmt):
    jl, tl = _pair("CQT1992", verbose=False, **{**SMALL, **kw})
    assert ("combined_real" in tl.state_dict()) == (not tl.trainable)
    for norm in NORMS:
        _compare(jl, tl, _signal(seed=5), fmt, norm)


# ----------------------------------------------------------- the pyramid --
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name,kw", [
    ("CQT2010v2", dict()),
    ("CQT2010v2", dict(earlydownsample=False)),
    ("CQT2010v2", dict(trainable=True)),
    ("CQT2010", dict()),
    ("CQT2010", dict(earlydownsample=False)),
    ("CQT2010", dict(trainable_STFT=True)),
    ("CQT2010", dict(trainable_CQT=True)),
    ("VQT", dict(gamma=0)),
    ("VQT", dict(gamma=3)),
    ("VQT", dict(gamma=3, trainable=True)),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}{x}" for k, x in v.items()) or "default")
def test_pyramid_matches_jax(name, kw, fmt):
    jl, tl = _pair(name, **{**PYRAMID, **kw})
    assert tl.n_octaves == jl.n_octaves == 3
    x = _signal(seed=6)
    for norm in NORMS:
        _compare(jl, tl, x, fmt, norm)


@pytest.mark.parametrize("name", ["CQT2010v2", "CQT2010", "VQT"])
def test_pyramid_with_early_downsampling_active(name):
    """A low top bin and a generous hop: the input is decimated by 4 first."""
    kw = dict(sr=22050, fmin=55, n_bins=24, bins_per_octave=12, hop_length=512)
    jl, tl = _pair(name, **kw)
    assert tl.earlydownsample and tl.downsample_factor == jl.downsample_factor > 1
    assert "early_downsample_filter" in tl.state_dict()
    off = getattr(tf, name)(**kw, earlydownsample=False, verbose=False, device="cpu")
    assert not off.earlydownsample and off.downsample_factor == 1.0
    x = _signal(22050, seed=7)
    for fmt in FORMATS:
        _compare(jl, tl, x, fmt, "librosa")


def test_pyramid_at_the_default_configuration():
    """84 bins in 7 octaves on 1 s: the per-octave loop at full depth."""
    jl, tl = _pair("CQT2010v2")
    assert tl.n_octaves == 7 and not tl.earlydownsample
    _compare(jl, tl, _signal(22050, batch=1, seed=8), "Complex", "librosa")


@pytest.mark.parametrize("name", ["CQT2010v2", "CQT2010", "VQT"])
def test_pyramid_empty_deepest_level(name):
    """An input whose deepest octaves downsample to empty levels still gives
    finite output: the empty level rides the reflect -> constant fallback."""
    x = np.random.RandomState(20).randn(1, 3).astype(np.float32)
    kw = dict(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12, hop_length=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jl, tl = _pair(name, **kw)
        want = jl(jnp.asarray(x))
        got = tl(x)
    assert got.shape[2] >= 1 and torch.isfinite(got).all()
    _close(got, want)


def test_pyramid_warns_on_a_hop_the_octaves_cannot_halve():
    with pytest.warns(UserWarning, match="not a multiple"):
        tf.CQT2010v2(sr=22050, hop_length=100, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="Nyquist"):
        tf.CQT2010v2(sr=8000, fmin=220, n_bins=84, verbose=False, device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_vqt_gamma_zero_equals_cqt2010v2_bit_for_bit(fmt):
    x = _signal(22050, batch=1)
    vqt = tf.VQT(sr=22050, gamma=0, verbose=False, device="cpu")
    cqt = tf.CQT2010v2(sr=22050, verbose=False, device="cpu")
    assert torch.equal(vqt(x, output_format=fmt), cqt(x, output_format=fmt))


@pytest.mark.parametrize("gamma", [1, 5, 10])
def test_vqt_gamma_matches_jax_at_the_default_configuration(gamma):
    jl, tl = _pair("VQT", gamma=gamma)
    assert tl._octave_widths == jl._octave_widths
    assert np.array_equal(_np(tl.lenghts), np.asarray(jl.params["lenghts"]))
    _compare(jl, tl, _signal(22050, batch=1, seed=9), "Magnitude", "librosa")


# -------------------------------------------------------------- gradients --
def _grads_match(jl, tl, x, names, fmt="Magnitude", tol=1e-4):
    assert set(tl.trainable_params()) == set(jl.trainable_params()) == set(names)
    want = jax.grad(lambda p: jnp.sum(jl.apply(p, x, output_format=fmt)))(
        jl.trainable_params())
    tl(x, output_format=fmt).sum().backward()
    for k in names:
        g = getattr(tl, k).grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, k
        _close(g, want[k], tol)


@pytest.mark.parametrize("fmt", ["Magnitude", "Complex"])
def test_cqt1992v2_trainable_gradients_match_jax(fmt):
    """The case of tests/test_cqt.py::test_cqt_trainable_grad."""
    kw = dict(sr=8000, fmin=55, n_bins=24, bins_per_octave=12, hop_length=256,
              trainable=True)
    jl, tl = _pair("CQT1992v2", **kw)
    x = np.random.RandomState(1).randn(1, 8192).astype(np.float32)
    _grads_match(jl, tl, x, ["cqt_kernels_real", "cqt_kernels_imag"], fmt)


@pytest.mark.parametrize("flags,names", [
    (dict(trainable_STFT=True), ["wsin", "wcos"]),
    (dict(trainable_CQT=True), ["cqt_kernels_real", "cqt_kernels_imag"]),
    (dict(trainable_STFT=True, trainable_CQT=True),
     ["wsin", "wcos", "cqt_kernels_real", "cqt_kernels_imag"]),
], ids=["STFT", "CQT", "both"])
def test_cqt1992_trainable_gradients_match_jax(flags, names):
    kw = dict(sr=8000, fmin=220, n_bins=24, bins_per_octave=12, hop_length=256)
    jl, tl = _pair("CQT1992", verbose=False, **kw, **flags)
    x = np.random.RandomState(1).randn(1, 8192).astype(np.float32)
    _grads_match(jl, tl, x, names)


def test_cqt2010v2_trainable_gradients_match_jax():
    jl, tl = _pair("CQT2010v2", **PYRAMID, trainable=True)
    _grads_match(jl, tl, _signal(4000, batch=1, seed=2),
                 ["cqt_kernels_real", "cqt_kernels_imag"])


# ---------------------------------------------------------- flat inverse --
def test_dual_synthesis_bank_matches_jax():
    from nnaudio_tpu.features.cqt import _dual_synthesis_bank as j_dual

    rng = np.random.RandomState(3)
    atoms = rng.randn(6, 128) + 1j * rng.randn(6, 128)
    for got, want in zip(_dual_synthesis_bank(atoms, 16, 1e-3), j_dual(atoms, 16, 1e-3)):
        assert got.dtype == np.float32
        _close(got, want, 1e-6)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,kw", [("CQT1992v2", dict(verbose=False)),
                                     ("CQT1992v2", dict(verbose=False, center=False)),
                                     ("CQT1992", dict())])
def test_flat_inverse_matches_jax(name, kw, norm):
    """The same Complex input through both ``.inverse``s (1e-3), with and
    without ``length``."""
    jl = getattr(jf, name)(**SMALL, output_format="Complex", **kw)
    tl = getattr(tf, name)(**SMALL, output_format="Complex", device="cpu", **kw)
    X = np.random.default_rng(0).standard_normal((2, 24, 40, 2)).astype(np.float32)
    _close(tl.inverse(X, normalization_type=norm),
           jl.inverse(jnp.asarray(X), normalization_type=norm), 1e-3)
    for length in (1500, 6000):  # a trim and a zero-padded shortfall
        got = tl.inverse(X, normalization_type=norm, length=length)
        assert got.shape == (2, length)
        _close(got, jl.inverse(jnp.asarray(X), normalization_type=norm,
                               length=length), 1e-3)


@pytest.mark.parametrize("norm", NORMS)
def test_icqt_roundtrip_snr(norm):
    """CQT -> inverse reconstructs in-band tones at > 40 dB interior SNR when
    the hop respects the shortest atom (tests/test_inverse_cqt.py:63-76)."""
    sr, hop = 22050, 128
    x = _tones(sr)
    layer = tf.CQT1992v2(sr=sr, fmin=55, n_bins=48, hop_length=hop,
                         output_format="Complex", verbose=False, device="cpu")
    X = layer(x, normalization_type=norm)
    xr = _np(layer.inverse(X, normalization_type=norm, length=x.shape[-1]))
    core = slice(4096, x.shape[-1] - 4096)
    err = xr[:, core] - x[:, core]
    snr = 10 * np.log10((x[:, core] ** 2).sum() / (err ** 2).sum())
    assert snr > 40, snr


def test_cqt1992_frozen_inverse_roundtrip_snr():
    sr, hop = 22050, 128
    x = _tones(sr)
    layer = tf.CQT1992(sr=sr, fmin=55, n_bins=48, hop_length=hop,
                       output_format="Complex", device="cpu")
    xr = _np(layer.inverse(layer(x), length=x.shape[-1]))
    core = slice(4096, x.shape[-1] - 4096)
    err = xr[:, core] - x[:, core]
    assert 10 * np.log10((x[:, core] ** 2).sum() / (err ** 2).sum()) > 40


def test_icqt_warns_on_undersampled_hop():
    """Default config (hop 512, 84 bins): the shortest atom is ~94 samples."""
    layer = tf.CQT1992v2(sr=22050, hop_length=512, n_bins=84,
                         output_format="Complex", verbose=False, device="cpu")
    X = layer(_tones())
    with pytest.warns(UserWarning, match="under-sampled"):
        layer.inverse(X)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _warn_undersampled_hop(40, [94.0, 200.0], "inverse CQT")


def test_inverse_rejects_what_it_cannot_invert():
    layer = tf.CQT1992v2(**SMALL, verbose=False, device="cpu")
    with pytest.raises(AssertionError, match="Complex format"):
        layer.inverse(np.zeros((1, 24, 10), np.float32))
    with pytest.raises(ValueError, match="normalization_type"):
        layer.inverse(np.zeros((1, 24, 10, 2), np.float32), normalization_type="bogus")
    for flags in (dict(trainable_STFT=True), dict(trainable_CQT=True)):
        trainable = tf.CQT1992(**SMALL, device="cpu", **flags)
        with pytest.raises(NotImplementedError, match="frozen composed basis"):
            trainable.inverse(np.zeros((1, 24, 10, 2), np.float32))


@pytest.mark.parametrize("how", ["update_params", "load_state_dict", "in_place"])
def test_dual_cache_dropped_when_the_kernels_change(how):
    """The dual kernels are derived from the bank: after the bank changes,
    ``inverse`` must rebuild them."""
    layer = tf.CQT1992v2(**SMALL, output_format="Complex", trainable=True,
                         verbose=False, device="cpu")
    X = np.random.default_rng(1).standard_normal((1, 24, 8, 2)).astype(np.float32)
    first = layer.inverse(X)
    assert len(layer._dual_cache) == 1
    assert torch.equal(layer.inverse(X), first) and len(layer._dual_cache) == 1
    doubled = layer.cqt_kernels_real.detach() * 2.0
    if how == "update_params":
        layer.update_params({"cqt_kernels_real": doubled})
        assert not layer._dual_cache
    elif how == "load_state_dict":
        layer.load_state_dict({**layer.state_dict(), "cqt_kernels_real": doubled})
        assert not layer._dual_cache
    else:  # what an optimizer step does
        with torch.no_grad():
            layer.cqt_kernels_real.mul_(2.0)
    assert not torch.allclose(layer.inverse(X), first)
    fresh = tf.CQT1992v2(**SMALL, output_format="Complex", verbose=False, device="cpu")
    fresh.update_params({"cqt_kernels_real": doubled})
    _close(layer.inverse(X), fresh.inverse(X), 1e-6)


def test_inverse_gradient_flows_to_the_input():
    layer = tf.CQT1992v2(**SMALL, output_format="Complex", verbose=False, device="cpu")
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 24, 8, 2)).astype(np.float32)).requires_grad_()
    layer.inverse(X).sum().backward()
    assert torch.isfinite(X.grad).all() and X.grad.abs().max() > 0


# ------------------------------------------------------------------ state --
STATE_CASES = [
    ("CQT1992v2", dict(**SMALL, trainable=True, verbose=False)),
    ("CQT", dict(**SMALL, verbose=False)),
    ("CQT1992", dict(**SMALL)),
    ("CQT1992", dict(**SMALL, trainable_CQT=True)),
    ("CQT2010", dict(**PYRAMID, verbose=False)),
    ("CQT2010v2", dict(**PYRAMID, verbose=False)),
    ("CQT2010v2", dict(sr=22050, fmin=55, n_bins=24, hop_length=512, verbose=False)),
    ("VQT", dict(**PYRAMID, gamma=3, verbose=False)),
]


@pytest.mark.parametrize("name,kw", STATE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(STATE_CASES)])
def test_jax_state_loads_and_reproduces_jax_output(name, kw):
    """A perturbed JAX ``state_dict()`` carried across by ``load_jax_state``
    gives the JAX transform's output; the keys are the same."""
    jl, tl = getattr(jf, name)(**kw), getattr(tf, name)(**kw, device="cpu")
    assert set(tl.state_dict()) == set(jl.state_dict())
    assert set(tl.trainable_params()) == set(jl.trainable_params())
    assert all(v.dtype == torch.float32 for v in tl.state_dict().values())
    rng = np.random.RandomState(14)
    state = {k: (v if k == "lenghts" else v * (1 + 0.05 * rng.randn(*v.shape)))
             .astype(np.float64) for k, v in jl.state_dict().items()}
    jl.load_state_dict(state)
    load_jax_state(tl, state)
    x = _signal(seed=10)
    for fmt in ("Magnitude", "Complex"):
        _compare(jl, tl, x, fmt, "librosa")
    with pytest.raises(RuntimeError):
        load_jax_state(tl, {k: v for k, v in state.items() if k != "lenghts"})


def test_pyramid_snapshot_with_legacy_cascade_keys_loads():
    """Older JAX snapshots stored the parallel chain's composed cascades:
    accepted under ``strict=True`` and ignored."""
    jl, tl = _pair("CQT2010v2", **PYRAMID)
    legacy = dict(jl.state_dict())
    legacy["lowpass_cascade_2"] = np.zeros(766, np.float32)
    jl.load_state_dict(legacy, strict=True)
    load_jax_state(tl, legacy, strict=True)
    assert "lowpass_cascade_2" not in tl.state_dict()
    _compare(jl, tl, _signal(seed=11), "Magnitude", "librosa")
    with pytest.raises(RuntimeError, match="bogus"):
        load_jax_state(tl, {**legacy, "bogus": np.zeros(1)})


def test_transforms_move_between_devices_as_modules():
    layer = tf.VQT(**PYRAMID, gamma=2, verbose=False, device="cpu")
    assert layer.device == torch.device("cpu")
    assert "VQT octaves = 3" in repr(layer)
    assert "CQT kernel size" in repr(tf.CQT2010v2(**PYRAMID, verbose=False, device="cpu"))
    assert "STFT kernel size" in repr(tf.CQT1992(**SMALL, device="cpu"))
