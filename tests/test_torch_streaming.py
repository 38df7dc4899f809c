"""The port's streaming classes against the JAX package's on the CPU.

One case per test of ``tests/test_streaming.py``. Each port stream is held
against the JAX stream on the same seeded numpy chunks at the framed ops'
1e-4 of max |ref| (ROADMAP), and against the port's own offline
``center=False`` transform at the JAX suite's tolerances: 1e-5 of max |ref|
for STFT, CQT and the inverse CQT; rtol 1e-4 with atol 1e-5 of max for Mel,
Gammatone and Chroma, atol 1e-4 of max for MFCC; 1e-5 on iSTFT's interior
and 2e-3 at its edges. On the route of a CUDA tensor (``kernel_route``, each
launch computed by its plain version and counted) a primed step launches its
kernel once and a priming step none.
"""
import numpy as np
import pytest
import torch

from nnaudio_tpu import streaming as jstreaming
from nnaudio_tpu_torch import config
from nnaudio_tpu_torch import features as tfeatures
from nnaudio_tpu_torch import streaming as tstreaming
from nnaudio_tpu_torch.ops import dispatch as td
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

REL = 1e-4  # port against JAX (ROADMAP: the framed ops)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(s, x, sizes, cat_axis=2):
    """Feed ``x`` in chunks cycling through ``sizes`` (hop multiples, the last
    one cut to what is left); concatenate the non-empty outputs."""
    state = s.init_state(x.shape[0])
    outs, pos, k = [], 0, 0
    while pos < x.shape[1]:
        c = min(sizes[k % len(sizes)], x.shape[1] - pos)
        state, out = s.step(state, x[:, pos:pos + c])
        pos, k = pos + c, k + 1
        if out.shape[cat_axis]:
            outs.append(_np(out))
    return np.concatenate(outs, axis=cat_axis)


def _pair(name, **kw):
    """The JAX stream and the port's (on the CPU) built with ``kw``."""
    return (getattr(jstreaming, name)(**kw),
            getattr(tstreaming, name)(device="cpu", **kw))


# ---------------------------------------------------------------- analysis --
STFT_CASES = [(n_fft, hop, fmt) for n_fft, hop in ((512, 128), (512, 160), (2048, 512))
              for fmt in ("Magnitude", "Complex")]


@pytest.mark.parametrize("n_fft,hop,fmt", STFT_CASES)
def test_stream_equals_offline(n_fft, hop, fmt):
    """Uneven hop-multiple chunks, some shorter than n_fft."""
    x = np.random.RandomState(0).randn(2, hop * 101 + (n_fft - hop)).astype(np.float32)
    x = x[:, : (x.shape[1] // hop) * hop]
    js, ts = _pair("StreamingSTFT", n_fft=n_fft, hop_length=hop, output_format=fmt)
    sizes = [hop, hop * 3, hop * 8, hop * 2, hop * 40]
    got, want_j = _run(ts, x, sizes), _run(js, x, sizes)
    offline = tfeatures.STFT(n_fft=n_fft, hop_length=hop, center=False,
                             output_format=fmt, verbose=False, device="cpu")
    want = _np(offline(x))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_stream_priming_short_chunks(kernel_route):
    """Chunks shorter than n_fft emit zero frames, and launch nothing, until
    primed; then each step is one K1 launch and the stream catches up."""
    n_fft, hop = 512, 128
    x = np.random.RandomState(1).randn(1, hop * 40).astype(np.float32)
    s = tstreaming.StreamingSTFT(n_fft=n_fft, hop_length=hop, device="cpu")
    state, outs, launches = s.init_state(1), [], []
    for pos in range(0, x.shape[1], hop):
        before = kernel_route["framed_magnitude"]
        state, frames = s.step(state, x[:, pos:pos + hop])
        outs.append(_np(frames))
        launches.append(kernel_route["framed_magnitude"] - before)
    assert all(o.shape[2] == 0 for o in outs[:3])
    assert launches == [0, 0, 0] + [1] * 37
    got = np.concatenate(outs, axis=2)
    want_j = np.concatenate([_np(f) for f in jstreaming.StreamingSTFT(
        n_fft=n_fft, hop_length=hop).stream(x, hop)], axis=2)
    want = _np(tfeatures.STFT(n_fft=n_fft, hop_length=hop, center=False,
                              output_format="Magnitude", verbose=False, device="cpu")(x))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("chunk", [np.zeros((1, 100), np.float32),
                                   torch.zeros(1, 100)], ids=["array", "tensor"])
def test_stream_rejects_bad_chunk(chunk):
    s = tstreaming.StreamingSTFT(n_fft=512, hop_length=128, device="cpu")
    with pytest.raises(ValueError, match="multiple of hop"):
        s.step(s.init_state(1), chunk)


def test_stream_rejects_a_chunk_on_another_device():
    s = tstreaming.StreamingSTFT(n_fft=512, hop_length=128, device="cpu")
    chunk = torch.zeros(1, 128, device="meta")
    with pytest.raises(ValueError, match="runs on cpu"):
        s.step(s.init_state(1), chunk)


def test_stream_generator_helper():
    """A trailing partial chunk (3 hops past the last full chunk_len) is
    processed, not dropped."""
    n_fft, hop = 512, 128
    x = np.random.RandomState(3).randn(1, hop * 67).astype(np.float32)
    js, ts = _pair("StreamingSTFT", n_fft=n_fft, hop_length=hop)
    got = np.concatenate([_np(f) for f in ts.stream(x, hop * 16)], axis=2)
    want_j = np.concatenate([_np(f) for f in js.stream(x, hop * 16)], axis=2)
    want = _np(tfeatures.STFT(n_fft=n_fft, hop_length=hop, center=False,
                              output_format="Magnitude", verbose=False, device="cpu")(x))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["Magnitude", "Complex"])
def test_streaming_cqt_matches_offline(fmt):
    kw = dict(sr=22050, hop_length=256, fmin=110, n_bins=48, bins_per_octave=12)
    js, ts = _pair("StreamingCQT", output_format=fmt, **kw)
    total = ((256 * 200 + ts.buf_cap) // 256) * 256
    x = np.random.RandomState(4).randn(1, total).astype(np.float32)
    got, want_j = _run(ts, x, [256 * 20]), _run(js, x, [256 * 20])
    offline = tfeatures.CQT1992v2(center=False, output_format=fmt, device="cpu", **kw)
    want = _np(offline(x, output_format=fmt))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# (class, constructor kwargs, offline class and kwargs, signal seed / batch /
# hops, chunk in hops, rtol, atol of max |ref|): tests/test_streaming.py
FILTERBANK_CASES = {
    "mel": ("StreamingMel", dict(sr=16000, n_fft=1024, hop_length=256, n_mels=64),
            "MelSpectrogram", dict(sr=16000, n_fft=1024, hop_length=256, n_mels=64),
            (2, 1, 80), 16, 1e-4, 1e-5),
    "mel power 1": ("StreamingMel", dict(sr=16000, n_fft=512, hop_length=128, n_mels=40,
                                         power=1.0),
                    "MelSpectrogram", dict(sr=16000, n_fft=512, hop_length=128, n_mels=40,
                                           power=1.0),
                    (6, 1, 60), 12, 1e-4, 1e-5),
    "mfcc": ("StreamingMFCC", dict(sr=16000, n_fft=1024, hop_length=256, n_mfcc=13,
                                   n_mels=40),
             "MFCC", dict(sr=16000, n_mfcc=13, top_db=None, n_fft=1024, hop_length=256,
                          n_mels=40),
             (7, 2, 70), 16, 1e-4, 1e-4),
    "gammatone": ("StreamingGammatone", dict(sr=16000, n_fft=1024, hop_length=256,
                                             n_bins=48, fmin=20),
                  "Gammatonegram", dict(sr=16000, n_fft=1024, hop_length=256, n_bins=48,
                                        fmin=20),
                  (8, 1, 70), 16, 1e-4, 1e-5),
    "chroma": ("StreamingChroma", dict(sr=22050, n_fft=2048, hop_length=512),
               "ChromaSTFT", dict(sr=22050, n_fft=2048, hop_length=512),
               (9, 1, 50), 10, 1e-4, 1e-5),
}


@pytest.mark.parametrize("case", list(FILTERBANK_CASES))
def test_streaming_filterbank_matches_offline(case):
    name, kw, off_name, off_kw, (seed, b, hops), chunk, rtol, atol = FILTERBANK_CASES[case]
    hop = kw["hop_length"]
    x = np.random.RandomState(seed).randn(b, hop * hops).astype(np.float32)
    js, ts = _pair(name, **kw)
    got, want_j = _run(ts, x, [hop * chunk]), _run(js, x, [hop * chunk])
    offline = getattr(tfeatures, off_name)(center=False, verbose=False, device="cpu", **off_kw)
    want = _np(offline(x))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


@pytest.mark.parametrize("case,kernel", [("mel", "framed_filterbank"),
                                         ("mel power 1", "framed_magnitude"),
                                         ("mfcc", "framed_filterbank"),
                                         ("gammatone", "framed_filterbank"),
                                         ("chroma", "framed_filterbank")])
def test_filterbank_step_is_one_launch(kernel_route, case, kernel):
    """Each primed step of a filterbank stream launches one kernel: K2 at
    power 2, K1 (and a matmul) at power 1."""
    name, kw, *_ = FILTERBANK_CASES[case]
    hop, n_fft = kw["hop_length"], kw["n_fft"]
    s = getattr(tstreaming, name)(device="cpu", **kw)
    x = np.random.RandomState(0).randn(1, hop * 8 + n_fft).astype(np.float32)
    state, _ = s.step(s.init_state(1), x[:, :n_fft])
    before = dict(kernel_route)
    for k in range(8):
        state, out = s.step(state, x[:, n_fft + hop * k: n_fft + hop * (k + 1)])
        assert out.shape[2] == 1
    assert {k: kernel_route[k] - before[k] for k in before} == {
        k: (8 if k == kernel else 0) for k in before}


def test_streaming_mfcc_rejects_top_db():
    with pytest.raises(ValueError, match="top_db"):
        tstreaming.StreamingMFCC(top_db=80.0, device="cpu")


# --------------------------------------------------------------- synthesis --
def test_streaming_istft_matches_offline(kernel_route):
    """Chunked synthesis == offline iSTFT(center=False), one K3 per step, and
    the analysis -> synthesis loop reconstructs the signal."""
    n_fft, hop, b, t_total = 512, 128, 2, 96
    x = np.random.RandomState(5).randn(b, (t_total - 1) * hop + n_fft).astype(np.float32)
    X = _np(tfeatures.STFT(n_fft=n_fft, hop_length=hop, center=False,
                           output_format="Complex", verbose=False, device="cpu")(x))
    want = _np(tfeatures.iSTFT(n_fft=n_fft, hop_length=hop, center=False,
                               verbose=False, device="cpu")(X, onesided=True))

    def run(s):
        state, outs, pos = s.init_state(b), [], 0
        for size in (1, 7, 20, 11, 40, t_total):
            size = min(size, t_total - pos)
            if size == 0:
                break
            state, samples = s.step(state, X[:, :, pos:pos + size])
            outs.append(_np(samples))
            pos += size
        outs.append(_np(s.flush(state)))
        return np.concatenate(outs, axis=1)
    before = kernel_route["synthesis_ola"]
    got = run(tstreaming.StreamingiSTFT(n_fft=n_fft, hop_length=hop, device="cpu"))
    assert kernel_route["synthesis_ola"] - before == 6  # one per step
    want_j = run(jstreaming.StreamingiSTFT(n_fft=n_fft, hop_length=hop))
    assert _rel(got, want_j) <= REL
    scale = np.abs(want).max()
    interior = slice(n_fft, -n_fft)
    np.testing.assert_allclose(got[:, interior], want[:, interior], atol=1e-5 * scale)
    np.testing.assert_allclose(got, want, atol=2e-3 * scale)
    np.testing.assert_allclose(got[:, interior], x[:, interior], atol=1e-4 * np.abs(x).max())


def test_streaming_inverse_cqt_matches_offline(kernel_route):
    """concat(steps..., flush()) equals the offline center=False dual
    synthesis, one K3 per step; StreamingCQT feeding it closes the loop."""
    kw = dict(sr=22050, fmin=55, n_bins=48, hop_length=128)
    off = tfeatures.CQT1992v2(center=False, output_format="Complex", verbose=False,
                              device="cpu", **kw)
    x = np.random.RandomState(7).randn(2, 128 * 160).astype(np.float32)
    X = _np(off(x))
    want = _np(off.inverse(X))

    def run(s):
        state, outs, T = s.init_state(2), [], X.shape[2]
        for a in range(0, T, 5):
            state, out = s.step(state, X[:, :, a:min(a + 5, T)])
            outs.append(_np(out))
        outs.append(_np(s.flush(state)))
        return np.concatenate(outs, axis=-1)
    sinv = tstreaming.StreamingInverseCQT(verbose=False, device="cpu", **kw)
    before = kernel_route["synthesis_ola"]
    got = run(sinv)
    assert kernel_route["synthesis_ola"] - before == -(-X.shape[2] // 5)
    want_j = run(jstreaming.StreamingInverseCQT(verbose=False, **kw))
    assert _rel(got, want_j) <= REL
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())

    scqt = tstreaming.StreamingCQT(output_format="Complex", verbose=False, device="cpu", **kw)
    a_state, s_state, pieces = scqt.init_state(2), sinv.init_state(2), []
    for pos in range(0, x.shape[-1], 128 * 16):
        a_state, frames = scqt.step(a_state, x[:, pos:pos + 128 * 16])
        if frames.shape[2]:
            s_state, out = sinv.step(s_state, frames)
            pieces.append(_np(out))
    pieces.append(_np(sinv.flush(s_state)))
    loop = np.concatenate(pieces, axis=-1)
    np.testing.assert_allclose(loop, want[:, :loop.shape[-1]], atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ the override --
def test_fuse_overrides_the_kernel_switches(kernel_route):
    """``fuse=True`` takes the kernels although config turned them off,
    ``fuse=False`` the plain versions although config has them on, ``None``
    follows config; each stream stays exact."""
    n_fft, hop = 512, 128
    x = np.random.RandomState(10).randn(1, hop * 40).astype(np.float32)
    want = _np(tfeatures.STFT(n_fft=n_fft, hop_length=hop, center=False,
                              output_format="Magnitude", verbose=False, device="cpu")(x))
    primed_steps = (x.shape[1] - n_fft) // (hop * 8) + 1
    for fuse, kernels_on, expect in ((False, True, 0), (True, False, primed_steps),
                                     (None, False, 0), (None, True, primed_steps)):
        config.set_use_kernels(kernels_on)
        try:
            before = kernel_route["framed_magnitude"]
            s = tstreaming.StreamingSTFT(n_fft=n_fft, hop_length=hop, fuse=fuse, device="cpu")
            got = _run(s, x, [hop * 8])
        finally:
            config.set_use_kernels(True)
        assert kernel_route["framed_magnitude"] - before == expect, (fuse, kernels_on)
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert td._FORCE_FUSE.get() is None  # restored


def test_force_fuse_reaches_synthesis_and_nests():
    config.set_use_kernels_synthesis(False)
    try:
        assert not td._synthesis_on()
        with td.force_fuse(True):
            assert td._synthesis_on() and td._analysis_on()
            with td.force_fuse(False):
                assert not td._synthesis_on() and not td._analysis_on()
            assert td._synthesis_on()
        assert not td._synthesis_on() and td._analysis_on()
    finally:
        config.set_use_kernels_synthesis(None)


def test_streaming_has_every_public_name_of_the_jax_module():
    names = {n for n, v in vars(jstreaming).items()
             if not n.startswith("_") and getattr(v, "__module__", None) == jstreaming.__name__}
    assert names == set(tstreaming.__all__)
    assert all(hasattr(tstreaming, n) for n in names)


def test_streams_refuse_the_cpu_without_a_device_argument():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    for name in tstreaming.__all__[1:]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tstreaming, name)()
