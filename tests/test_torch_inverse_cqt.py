"""The port's pyramid inverses (CQT2010, CQT2010v2, VQT) and GriffinLimCQT
against the JAX package's on the same numpy inputs, on the CPU.

The inverses reconstruct seeded in-band tones at the config of
tests/test_inverse_cqt.py (sr 22050, fmin 55, 48 bins, hop 128) with an
interior SNR above 40 dB (35 dB with early downsampling at hop 64), and
agree with JAX's reconstruction within 1e-3 of max |ref|. GriffinLimCQT
runs 2 iterations from JAX's drawn phase and agrees with JAX's loop within
the port's Griffin-Lim tolerances (5e-4 with fp32 carries, 3e-2 with bf16
carries, tests/test_torch_griffin_lim.py).
"""
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nnaudio_tpu as jn
import nnaudio_tpu_torch as tn
from nnaudio_tpu import features as jf
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.interop import load_jax_state
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

INV_TOL = 1e-3
GL_TOL = {"highest": 5e-4, "default": 3e-2}
CFG = dict(sr=22050, fmin=55, n_bins=48, bins_per_octave=12, hop_length=128,
           earlydownsample=False, verbose=False)
FAMILY = {"CQT2010v2": {}, "VQT": dict(gamma=5.0), "CQT2010": {}}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tones(sr=22050, secs=1.0, freqs=(110, 220, 330, 440, 660)):
    t = np.arange(int(sr * secs)) / sr
    return sum(np.sin(2 * np.pi * f * t + i)
               for i, f in enumerate(freqs)).astype(np.float32)[None]


def _snr(xr, x, guard=4096):
    xr, x = _np(xr), _np(x)
    core = slice(guard, x.shape[-1] - guard)
    err = xr[:, core] - x[:, core]
    return 10 * np.log10((x[:, core] ** 2).sum() / (err ** 2).sum())


def _pair(cls, **kw):
    kw = {**CFG, **FAMILY[cls], **kw}
    return getattr(jf, cls)(**kw), getattr(tf, cls)(**kw, device="cpu")


# ---------------------------------------------------------------- inverse --
@pytest.mark.parametrize("norm", ["librosa", "convolutional", "wrap"])
@pytest.mark.parametrize("cls", list(FAMILY))
def test_pyramid_inverse_round_trip_matches_jax(cls, norm):
    jl, tl = _pair(cls, output_format="Complex")
    x = _tones()
    with torch.no_grad():
        rec = tl.inverse(tl(x, normalization_type=norm), normalization_type=norm,
                         length=x.shape[-1])
    want = np.asarray(jl.inverse(jl(x, normalization_type=norm),
                                 normalization_type=norm, length=x.shape[-1]))
    assert _snr(rec, x) > 40, _snr(rec, x)
    assert _rel(rec, want) <= INV_TOL


def test_pyramid_inverse_early_downsample_matches_jax():
    """tests/test_inverse_cqt.py:191: the early FIR is part of the composed
    atoms; the reconstruction is at the original rate."""
    jl, tl = _pair("CQT2010v2", output_format="Complex", hop_length=64,
                   earlydownsample=True)
    assert tl.earlydownsample and tl.downsample_factor > 1
    x = _tones()
    with torch.no_grad():
        rec = tl.inverse(tl(x), length=x.shape[-1])
    assert rec.shape == x.shape
    assert _snr(rec, x) > 35, _snr(rec, x)
    assert _rel(rec, np.asarray(jl.inverse(jl(x), length=x.shape[-1]))) <= INV_TOL


@pytest.mark.parametrize("cls", list(FAMILY))
def test_pyramid_dual_bank_matches_jax(cls):
    """The collapsed dual bank, its offset and hop, against JAX's build."""
    jl, tl = _pair(cls)
    kc, ks, start, hop = tl._pyramid_dual_kernels("librosa", 1e-3)
    jkc, jks, jstart, jhop = jl._pyramid_dual_kernels("librosa", 1e-3)
    assert (start, hop) == (jstart, jhop)
    assert _rel(kc, jkc) <= 1e-5 and _rel(ks, jks) <= 1e-5


def test_pyramid_inverse_natural_length_and_no_length():
    _, tl = _pair("CQT2010v2", output_format="Complex")
    X = tl(_tones(secs=0.5))
    kc, _, start, hop = tl._pyramid_dual_kernels("librosa", 1e-3)
    available = kc.shape[1] + hop * (X.shape[2] - 1) - start
    with torch.no_grad():
        out = tl.inverse(X)
        longer = tl.inverse(X, length=available + 300)
    assert out.shape == (1, 128 * (X.shape[2] - 1))
    assert longer.shape == (1, available + 300)
    assert torch.equal(longer[:, :out.shape[1]], out)
    assert float(longer[:, -300:].abs().max()) == 0.0


def test_pyramid_inverse_warns_on_undersampled_hop():
    tl = tf.CQT2010v2(sr=22050, hop_length=512, n_bins=84, output_format="Complex",
                      verbose=False, device="cpu")
    X = tl(_tones(secs=0.5))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tl.inverse(X)
    assert any("under-sampled" in str(m.message) for m in w)


def test_pyramid_inverse_rejects_a_magnitude():
    _, tl = _pair("CQT2010v2")
    with pytest.raises(AssertionError):
        tl.inverse(torch.zeros(1, 48, 10))
    _, t2010 = _pair("CQT2010", trainable_CQT=True)
    with pytest.raises(NotImplementedError):
        t2010.inverse(torch.zeros(1, 48, 10, 2))


def test_pyramid_dual_cache_follows_the_bank():
    """update_params and an in-place change both rebuild the dual bank."""
    _, tl = _pair("CQT2010v2")
    first = tl._pyramid_dual_kernels("librosa", 1e-3)[0]
    assert tl._pyramid_dual_kernels("librosa", 1e-3)[0] is first
    tl.update_params({"cqt_kernels_real": tl.cqt_kernels_real * 2.0})
    assert not tl._dual_cache
    second = tl._pyramid_dual_kernels("librosa", 1e-3)[0]
    assert float((second - first).abs().max()) > 0
    with torch.no_grad():
        tl.cqt_kernels_imag.mul_(0.5)
    assert tl._pyramid_dual_kernels("librosa", 1e-3)[0] is not second


@pytest.mark.parametrize("cls", ["CQT2010v2", "VQT"])
def test_pyramid_inverse_launches(kernel_route, cls):
    """On the card's route: the pair (K5) once per octave, then one K3."""
    _, tl = _pair(cls, output_format="Complex")
    with torch.no_grad():
        tl.inverse(tl(_tones(secs=0.5)))
    assert kernel_route["framed_pair"] == tl.n_octaves
    assert kernel_route["synthesis_ola"] == 1
    assert kernel_route["framed_magnitude"] == kernel_route["framed_filterbank"] == 0
    assert kernel_route["framed_filterbank_fft"] == 0


# ------------------------------------------------------------ GriffinLimCQT --
GL_FAMILIES = {"1992v2": ("CQT1992v2", {}), "2010v2": ("CQT2010v2", {}),
               "vqt": ("VQT", dict(gamma=5.0))}


def _gl_pair(family, n_iter=2, **kw):
    cls, extra = GL_FAMILIES[family]
    ctor = dict(sr=22050, fmin=55, n_bins=48, bins_per_octave=12, hop_length=128,
                family=family, n_iter=n_iter, verbose=False, **kw)
    if family != "1992v2":
        ctor.update(earlydownsample=False, **extra)
    return jf.GriffinLimCQT(**ctor), tf.GriffinLimCQT(**ctor, device="cpu")


def _magnitude(family, secs=0.5):
    cls, extra = GL_FAMILIES[family]
    kw = dict(sr=22050, fmin=55, n_bins=48, bins_per_octave=12, hop_length=128,
              output_format="Magnitude", verbose=False)
    if family != "1992v2":
        kw.update(earlydownsample=False, **extra)
    return np.asarray(getattr(jf, cls)(**kw)(_tones(secs=secs)))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("family", list(GL_FAMILIES))
def test_griffinlim_cqt_matches_jax(family, precision):
    """2 iterations from the phase JAX draws with PRNGKey(0)."""
    jl, tl = _gl_pair(family, iter_precision=precision)
    S = _magnitude(family)
    phase = np.asarray(jax.random.normal(jax.random.PRNGKey(0), S.shape))
    want = np.asarray(jl(S, key=jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = tl(S, rand_phase=phase)
    assert np.isfinite(_np(got)).all()
    assert _rel(got, want) <= GL_TOL[precision]


@pytest.mark.parametrize("family", list(GL_FAMILIES))
def test_griffinlim_cqt_launches(kernel_route, family):
    """Per iteration one K3 and the re-analysis's pairs (one for 1992v2, one
    per octave for the pyramids), and one K3 more for the final synthesis."""
    _, tl = _gl_pair(family, n_iter=3)
    with torch.no_grad():
        out = tl(_magnitude(family), length=11025)
    assert out.shape == (1, 11025)
    per = 1 if family == "1992v2" else tl._cqt.n_octaves
    assert kernel_route["framed_pair"] == 3 * per
    assert kernel_route["synthesis_ola"] == 4
    assert kernel_route["framed_magnitude"] == kernel_route["framed_filterbank"] == 0
    assert kernel_route["framed_filterbank_fft"] == 0


def test_griffinlim_cqt_converges():
    """8 iterations on the 2010v2 pyramid: the re-analysed magnitude within
    0.3 of the target by spectral convergence (tests/test_inverse_cqt.py
    holds 0.2 at 32 iterations)."""
    _, tl = _gl_pair("2010v2", n_iter=8)
    cqt = tf.CQT2010v2(**CFG, output_format="Magnitude", device="cpu")
    S = cqt(_tones(secs=0.5))
    with torch.no_grad():
        rec = tl(S, generator=torch.Generator().manual_seed(1), length=11025)
        S2 = cqt(rec)
    sc = float(torch.linalg.vector_norm(S2 - S) / torch.linalg.vector_norm(S))
    assert sc < 0.3, sc


def test_griffinlim_cqt_generator_and_default_phase():
    _, tl = _gl_pair("1992v2")
    S = torch.tensor(_magnitude("1992v2"))
    with torch.no_grad():
        a = tl(S)
        b = tl(S, generator=torch.Generator().manual_seed(0))
        c = tl(S, rand_phase=torch.randn(S.shape, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError):
        tl(S, rand_phase=torch.zeros(1, 2, 3))
    with pytest.raises(AssertionError):
        tl(S[0])


def test_griffinlim_cqt_rejects_unknown_family_and_precision():
    with pytest.raises(ValueError):
        tf.GriffinLimCQT(family="2010", verbose=False, device="cpu")
    with pytest.raises(ValueError):
        tf.GriffinLimCQT(iter_precision="fast", verbose=False, device="cpu")


def test_griffinlim_cqt_apply_rejects_bank_overrides():
    _, tl = _gl_pair("1992v2")
    S = _magnitude("1992v2")
    with pytest.raises(ValueError, match="update_params"):
        tl.apply({"cqt_kernels_real": tl.cqt_kernels_real * 2}, S)


def test_griffinlim_cqt_update_params_rebuilds_duals():
    """A persistent bank update reaches both halves: the analysis bank is
    the transform's own tensor and the duals are rebuilt from it."""
    jl, tl = _gl_pair("1992v2")
    old = tl._dual_kc.clone()
    tl.update_params({"cqt_kernels_real": tl.cqt_kernels_real * 2.0})
    assert float((tl._dual_kc - old).abs().max()) > 0
    assert tl._cqt.cqt_kernels_real is tl.cqt_kernels_real
    jl.update_params({"cqt_kernels_real": jl._params["cqt_kernels_real"] * 2.0})
    assert _rel(tl._dual_kc, np.asarray(jl._dual_kc)) <= 1e-5


@pytest.mark.parametrize("family", list(GL_FAMILIES))
def test_griffinlim_cqt_state_keys_and_jax_snapshot(family):
    jl, tl = _gl_pair(family)
    assert set(tl.state_dict()) == set(jl.state_dict())
    snap = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    if family != "1992v2":
        # an older JAX snapshot also stored the chain's composed cascades
        snap["lowpass_cascade_2"] = np.zeros(766, np.float32)
    load_jax_state(tl, snap)


def test_griffinlim_cqt_pyramid_under_parallel_chain():
    """tests/test_inverse_cqt.py:290: the loop's pyramid forward takes the
    parallel chain when it is on."""
    jl, tl = _gl_pair("2010v2", n_iter=2)
    S = _magnitude("2010v2")
    phase = np.asarray(jax.random.normal(jax.random.PRNGKey(0), S.shape))
    tn.set_use_parallel_chain(True)
    jn.set_use_parallel_chain(True)
    try:
        with torch.no_grad():
            got = tl(S, rand_phase=phase)
        want = np.asarray(jl(S, key=jax.random.PRNGKey(0)))
    finally:
        tn.set_use_parallel_chain(None)
        jn.set_use_parallel_chain(None)
    assert _rel(got, want) <= GL_TOL["default"]
