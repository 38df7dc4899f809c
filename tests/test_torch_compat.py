"""The port's function-level compat layer, ``Spectrogram`` shim and
``features`` namespace against the JAX package's, on the CPU.

Every name of ``nnaudio_tpu.compat.__all__`` exists in the port, and each
function returns what the JAX function returns on the same numpy inputs: the
host builders (numpy in both packages) exactly, the tensor helpers within
1e-6 of max |ref| (the same float32 sums in another order; the CQT product
within the framed ops' 1e-4). ``uniform_distribution`` draws from a
``torch.Generator`` where JAX takes a PRNG key, so only its shape and range
are held.
"""
import warnings

import numpy as np
import pytest
import torch

from nnaudio_tpu import compat as jc
from nnaudio_tpu import features as jfeatures
from nnaudio_tpu_torch import compat as tc
from nnaudio_tpu_torch import features as tfeatures


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rng(seed):
    return np.random.RandomState(seed)


# name -> (positional args, keyword args) for the host builders
HOST = {
    "create_fourier_kernels": ((256,), dict(freq_bins=100, sr=16000, freq_scale="log",
                                            verbose=False)),
    "create_cqt_kernels": ((17.0, 16000, 55.0), dict(n_bins=36)),
    "create_lowpass_filter": ((), dict(band_center=0.5, kernelLength=64,
                                       transitionBandwidth=0.01)),
    "get_window_dispatch": (("hann", 64), {}),
    "get_mel": ((16000, 512), dict(n_mels=40)),
    "get_gammatone": ((16000, 512), dict(n_bins=32)),
    "chroma": ((22050, 2048), dict(tuning=0.1)),
    "nextpow2": ((1000,), {}),
    "prepow2": ((1000,), {}),
    "hz_to_mel": ((np.array([110.0, 440.0, 4000.0]),), {}),
    "mel_to_hz": ((np.array([1.0, 10.0, 40.0]),), {}),
    "mel_frequencies": ((20,), dict(fmax=8000.0)),
    "fft_frequencies": ((), dict(sr=16000, n_fft=512)),
    "hz_to_octs": ((np.array([110.0, 440.0]),), {}),
    "pad_center": ((np.hanning(32), 64), {}),
    "get_early_downsample_params": ((22050, 512, 4000.0, 17.0, 7), {}),
    "early_downsample": ((22050, 512, 7, 11025.0, 4000.0), {}),
    "early_downsample_count": ((11025.0, 4000.0, 512, 7), {}),
    "fft2gammatonemx": ((), dict(sr=16000, n_fft=512, n_bins=24, fmax=8000)),
    "normalize": ((_rng(0).rand(12, 30).astype(np.float32),), dict(norm=2)),
    "tiny": ((np.float32(1.0),), {}),
}


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None or isinstance(a, (bool, str)):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_builders_equal_the_jax_package(name):
    args, kw = HOST[name]
    _equal(getattr(tc, name)(*args, **kw), getattr(jc, name)(*args, **kw))


def _cqt_bank():
    kernels, *_ = jc.create_cqt_kernels(17.0, 16000, 110.0, n_bins=24)
    return kernels.real.astype(np.float32), kernels.imag.astype(np.float32)


# name -> (args, tolerance of max |ref|) for the tensor helpers, on numpy inputs
TENSOR = {
    "broadcast_dim": ((_rng(1).randn(3, 1, 50).astype(np.float32),), 0.0),
    "complex_mul": (((_rng(2).randn(12, 33).astype(np.float32),
                      _rng(3).randn(12, 33).astype(np.float32)),
                     (_rng(4).randn(3, 33, 21).astype(np.float32),
                      _rng(5).randn(3, 33, 21).astype(np.float32))), 1e-6),
    "extend_fbins": ((_rng(6).randn(2, 33, 7, 2).astype(np.float32),), 0.0),
    "overlap_add": ((_rng(7).randn(2, 64, 9).astype(np.float32), 16), 1e-6),
    "torch_window_sumsquare": ((np.hanning(64).astype(np.float32), 7, 16, 64), 1e-6),
    "downsampling_by_n": ((_rng(8).randn(2, 1, 1000).astype(np.float32),
                           jc.create_lowpass_filter(0.5, 64, 0.01).astype(np.float32), 4), 1e-6),
    "downsampling_by_2": ((_rng(9).randn(2, 1000).astype(np.float32),
                           jc.create_lowpass_filter(0.5, 64, 0.01).astype(np.float32)), 1e-6),
    "get_cqt_complex": ((_rng(10).randn(2, 4000).astype(np.float32), *_cqt_bank(), 256,
                         "reflect"), 1e-4),
    "rfft_fn": ((_rng(11).randn(2, 100).astype(np.float32),), 1e-6),
}


@pytest.mark.parametrize("name", sorted(TENSOR))
def test_tensor_helpers_match_the_jax_package(name):
    args, tol = TENSOR[name]
    got = getattr(tc, name)(*args, device="cpu")
    want = getattr(jc, name)(*args)
    if isinstance(want, tuple):
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), np.abs(g - w).max()


def test_rfft_fn_onesided_and_padded():
    x = _rng(12).randn(3, 50).astype(np.float32)
    got = _np(tc.rfft_fn(x, n=64, onesided=True, device="cpu"))
    want = np.asarray(jc.rfft_fn(x, n=64, onesided=True))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_tensor_helpers_keep_a_tensor_where_it_lies():
    x = torch.randn(2, 64, 9)
    assert tc.overlap_add(x, 16).device == x.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.overlap_add(x.numpy(), 16)


def test_uniform_distribution_draws_in_its_range():
    g = torch.Generator().manual_seed(3)
    u = tc.uniform_distribution(-1.0, 2.0, 4, 5, device="cpu", generator=g)
    w = np.asarray(jc.uniform_distribution(-1.0, 2.0, 4, 5))
    assert u.shape == w.shape == (4, 5)
    # (r1 - r2) * U[0, 1) + r2 lies in (-1, 2]
    assert float(u.min()) > -1.0 and float(u.max()) <= 2.0


def test_every_compat_name_and_constant():
    assert set(tc.__all__) == set(jc.__all__)
    for name in jc.__all__:
        assert hasattr(tc, name), name
    assert (tc.epsilon, tc.sz_float) == (jc.epsilon, jc.sz_float)
    assert set(HOST) | set(TENSOR) | {"uniform_distribution", "epsilon", "sz_float"} == set(
        jc.__all__)


def test_features_namespace_equals_the_jax_package():
    assert set(tfeatures.__all__) == set(jfeatures.__all__)
    for name in jfeatures.__all__:
        assert hasattr(tfeatures, name), name
    assert tfeatures.STFTBase is tfeatures.SpectralTransform
    assert issubclass(tfeatures.STFT, tfeatures.STFTBase)
    assert tfeatures.get_mel is tc.get_mel


def test_spectrogram_shim_warns_like_the_jax_package():
    import importlib
    import sys

    def warning_of(module):
        sys.modules.pop(module, None)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod = importlib.import_module(module)
        return mod, [str(r.message) for r in rec if r.category is DeprecationWarning]
    tmod, tmsg = warning_of("nnaudio_tpu_torch.Spectrogram")
    _, jmsg = warning_of("nnaudio_tpu.Spectrogram")
    assert tmsg == jmsg and len(tmsg) == 1
    assert set(tmod.__all__) == set(jfeatures.__all__)
    assert tmod.STFT is tfeatures.STFT


def test_package_attributes_load_lazily():
    """Importing the package loads neither parallel nor utils (nor
    torch.distributed.checkpoint); the attributes load them on first use."""
    import subprocess
    import sys

    code = ("import sys, nnaudio_tpu_torch as n\n"
            "lazy = ('nnaudio_tpu_torch.parallel', 'nnaudio_tpu_torch.utils', "
            "'nnaudio_tpu_torch.streaming', 'nnaudio_tpu_torch.Spectrogram', "
            "'torch.distributed.checkpoint')\n"
            "assert not [m for m in lazy if m in sys.modules], sys.modules.keys()\n"
            "assert n.streaming.StreamingSTFT and n.parallel.make_mesh and n.utils.trace\n"
            "assert n.filters.mel_filterbank and n.core.frame_signal and n.ops.force_fuse\n"
            "assert 'streaming' in n.__all__\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
