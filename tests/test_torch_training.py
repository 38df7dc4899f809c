"""Training on the port against ``jax.grad`` on the same numpy inputs, on the
CPU: the gradients of the framed ops, of the trainable STFT, Mel, MFCC, CQT
and iSTFT, of a frozen STFT's input on silent frames, and the classifier's
``train_step``.

Each runs on two routes. ``plain`` is the CPU route: the plain versions,
differentiated by autograd. ``kernel`` is the route a CUDA tensor takes,
with each kernel launch replaced by its plain version (``kernel_route``):
the wrappers' choice under grad (the pair, K5, in place of K1, K2 and K6),
the autograd functions of K3 and K5 and their backwards are the card's.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu.filters.fourier import create_fourier_basis
from nnaudio_tpu.models import SpectrogramClassifier as JClassifier
from nnaudio_tpu.models import train_step as j_train_step
from nnaudio_tpu.ops import dispatch as jd
from nnaudio_tpu_torch import config
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.models import SpectrogramClassifier, train_step
from nnaudio_tpu_torch.ops import dispatch as td
from nnaudio_tpu_torch.ops import framed_kernels as fk

TOL = 1e-4     # the framed ops (tests/test_ops.py)
RT_TOL = 1e-3  # round trips
FAST_TOL = 5e-2  # bf16 storage (tests/test_ops.py:215)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel_err(got, want):
    """max |got - want| / max |want|, shapes equal"""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, tol=TOL):
    assert np.isfinite(_np(got)).all()
    assert _rel_err(got, want) <= tol, _rel_err(got, want)


@pytest.fixture
def kernel_route(monkeypatch):
    """Every wrapper takes the branch of a CUDA tensor, and each kernel
    launch computes its plain version instead. Returns the launches, by
    kernel, counted as the wrappers count theirs."""
    calls = {k: 0 for k in ("framed_magnitude", "framed_magnitude_kchunk",
                            "framed_filterbank", "framed_pair", "synthesis_ola",
                            "framed_filterbank_fft", "synthesis_ola_fft", "gl_step_fft")}

    def launch(name, plain):
        def run(*args):
            calls[name] += 1
            return plain(*args)
        return run
    monkeypatch.setattr(fk, "_on_card", lambda t: True)
    monkeypatch.setattr(fk, "_launch_magnitude", launch(
        "framed_magnitude", fk.framed_magnitude_plain))
    monkeypatch.setattr(fk, "_launch_magnitude_kchunk", launch(
        "framed_magnitude_kchunk",
        lambda x, wc, ws, hop, eps, square, splits:
            fk.framed_magnitude_plain(x, wc, ws, hop, eps, square)))
    monkeypatch.setattr(fk, "_launch_filterbank", launch(
        "framed_filterbank", fk.framed_filterbank_plain))
    monkeypatch.setattr(fk, "_launch_filterbank_fft", launch(
        "framed_filterbank_fft",
        lambda x, wc, ws, fb, hop, eps, plan:
            fk.framed_filterbank_fft_plain(x, wc, ws, fb, hop, eps)))
    monkeypatch.setattr(fk, "_launch_pair", launch("framed_pair", fk.framed_pair_plain))
    monkeypatch.setattr(fk, "_launch_synthesis", launch(
        "synthesis_ola", fk.synthesis_ola_plain))
    monkeypatch.setattr(fk, "_launch_synthesis_fft", launch(
        "synthesis_ola_fft",
        lambda sre, sim, hop, plan: fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop)))
    monkeypatch.setattr(fk, "_launch_gl_step_fft", launch(
        "gl_step_fft", lambda *args: fk.gl_step_fft_plain(*args[:-1])))
    monkeypatch.setattr(fk, "_launch_nnls", lambda *args: fk.nnls_banded_plain(*args[:-1]))
    return calls


@pytest.fixture(params=["plain", "kernel"])
def route(request):
    """None on the plain route; the launch counts on the kernel route."""
    if request.param == "kernel":
        return request.getfixturevalue("kernel_route")
    return None


def _no_fused_analysis(calls):
    """Under grad no K1, K2 (either route) or K6 ran: the pair did."""
    if calls is not None:
        assert calls["framed_magnitude"] == calls["framed_filterbank"] == 0
        assert calls["framed_filterbank_fft"] == 0
        assert calls["framed_magnitude_kchunk"] == 0
        assert calls["framed_pair"] >= 1


# ------------------------------------------------------------ framed ops --
def _synthesis_inputs():
    """tests/test_ops.py:367: n_fft 64, hop 16, 33 bins, 5 frames."""
    n_fft = 64
    basis = create_fourier_basis(n_fft, window="hann")
    rng = np.random.RandomState(2)
    sre = rng.randn(1, 33, 5).astype(np.float32)
    sim = rng.randn(1, 33, 5).astype(np.float32)
    return [sre, sim, (basis.wcos / n_fft).astype(np.float32),
            (basis.wsin / n_fft).astype(np.float32)]


def _analysis_inputs(seed, fb=False, scale=False):
    """tests/test_ops.py:121,166,315,484: x (1, 512), 17 x 64 bases, hop 16."""
    rng = np.random.RandomState(seed)
    out = [rng.randn(1, 512).astype(np.float32),
           rng.randn(17, 64).astype(np.float32),
           rng.randn(17, 64).astype(np.float32)]
    if fb:
        out.append(np.abs(rng.randn(6, 17)).astype(np.float32))
    if scale:
        out.append(rng.rand(17).astype(np.float32) + 0.5)
        out.append(rng.randn(1, 17, 29, 2).astype(np.float32))  # the target
    return out


def _op_case(name):
    """(numpy inputs, number of differentiated inputs, JAX loss, port loss)
    of the JAX suite's five custom-VJP tests, and of the power."""
    if name == "pair":  # tests/test_ops.py:121
        def loss(m, x, wc, ws):
            r, i = m.framed_basis_pair(x, wc, ws, 16)
            return (r ** 2).sum() + (i ** 2).sum()
        return _analysis_inputs(4), 3, loss
    if name == "magnitude":  # tests/test_ops.py:166
        return _analysis_inputs(6), 3, \
            lambda m, x, wc, ws: (m.framed_magnitude(x, wc, ws, 16, 1e-8) ** 2).sum()
    if name == "power":
        return _analysis_inputs(6), 3, \
            lambda m, x, wc, ws: (m.framed_power(x, wc, ws, 16) ** 2).sum()
    if name == "synthesis":  # tests/test_ops.py:367
        return _synthesis_inputs(), 4, \
            lambda m, sre, sim, kc, ks: (m.synthesis_ola(sre, sim, kc, ks, 16) ** 2).sum()
    if name == "filterbank":  # tests/test_ops.py:315
        return _analysis_inputs(8, fb=True), 4, \
            lambda m, x, wc, ws, fb: (m.framed_filterbank(x, wc, ws, fb, 16, 1e-8) ** 2).sum()
    assert name == "complex"  # tests/test_ops.py:484
    *args, tgt = _analysis_inputs(33, scale=True)

    def loss(m, x, wc, ws, s):
        t = tgt if m is jd else torch.from_numpy(tgt)
        return ((m.framed_complex(x, wc, ws, s, 16) - t) ** 2).sum()
    return args, 4, loss


@pytest.mark.parametrize("name", ["pair", "magnitude", "power", "synthesis",
                                  "filterbank", "complex"])
def test_framed_op_gradients_match_jax(route, name):
    args, n, loss = _op_case(name)
    want = jax.grad(lambda *a: loss(jd, *a), argnums=tuple(range(n)))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    loss(td, *leaves).backward()
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)
    if route is not None and name == "synthesis":
        # forward K3, backward the pair of the cotangent signal (K5)
        assert route["synthesis_ola"] == 1 and route["framed_pair"] == 1
    elif name != "synthesis":
        _no_fused_analysis(route)


def test_synthesis_backward_chunks_dw_like_jax(monkeypatch):
    """K3's backward (``synthesis_ola_backward``, the spectra through the
    pair, the kernels' dW in chunks of 2 frames) against ``jax.grad``."""
    args = _synthesis_inputs()
    g = np.random.RandomState(5).randn(1, 64 + 16 * 4).astype(np.float32)
    want = jax.grad(lambda *a: (jd.synthesis_ola(*a, 16) * g).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    monkeypatch.setattr(fk, "DW_CHUNK_ELEMS", 2 * 64 * 2)
    got = fk.synthesis_ola_backward(*map(torch.from_numpy, args),
                                    torch.from_numpy(g), 16)
    for a, w in zip(got, want):
        _close(a, w)
    assert fk.synthesis_ola_backward(*map(torch.from_numpy, args), torch.from_numpy(g),
                                     16, needs=(False, False, True, False))[:2] == (None, None)


@pytest.mark.parametrize("op", ["magnitude", "power", "filterbank", "kchunk"])
def test_route_under_grad_takes_the_pair(kernel_route, monkeypatch, op):
    """Under grad the magnitude, power and filterbank ops call
    ``fk.framed_pair`` and launch no K1, K2 or K6; under ``torch.no_grad()``,
    or with nothing that requires grad, they launch their own kernel and
    never call the pair. A frozen basis with an input that requires grad
    takes the pair too."""
    pairs = []
    pair = fk.framed_pair
    monkeypatch.setattr(fk, "framed_pair", lambda *a: pairs.append(1) or pair(*a))
    rng = np.random.RandomState(0)
    n = 4096 if op == "kchunk" else 256  # K6's envelope: <= 128 bins, N >= 2048
    x = torch.from_numpy(rng.randn(1, n + 64 * 7).astype(np.float32))
    wc, ws = (torch.from_numpy(rng.randn(33, n).astype(np.float32) * 0.05)
              for _ in range(2))
    fb = torch.from_numpy(rng.rand(5, 33).astype(np.float32))
    own = {"magnitude": "framed_magnitude", "power": "framed_magnitude",
           "filterbank": "framed_filterbank", "kchunk": "framed_magnitude_kchunk"}[op]

    def run():
        if op == "power":
            return td.framed_power(x, wc, ws, 64)
        if op == "filterbank":
            return td.framed_filterbank(x, wc, ws, fb, 64, eps=1e-8)
        return td.framed_magnitude(x, wc, ws, 64, eps=1e-8)

    ref = run()  # nothing requires grad
    assert not pairs and kernel_route[own] == 1 and ref.grad_fn is None
    for leaf in (wc, x):  # a trainable basis; a frozen one and an input
        leaf.requires_grad_()
        with torch.no_grad():
            run()
        assert not pairs and kernel_route[own] == 2
        out = run()
        assert len(pairs) == 1 and kernel_route[own] == 2 and out.grad_fn is not None
        _close(out, ref, 1e-6)
        out.sum().backward()
        assert torch.isfinite(leaf.grad).all()
        leaf.requires_grad_(False)
        pairs.clear()
        kernel_route[own] = 1


def test_silent_frames_have_a_finite_input_gradient(route):
    """A frozen STFT Magnitude on a signal silent for its first half: the
    input gradient is JAX's, finite, and zero where JAX's is (``_mag_bwd``'s
    safe divide; ``torch.sqrt``'s own backward gives NaN there)."""
    x = np.random.RandomState(9).randn(1, 4096).astype(np.float32)
    x[:, :2048] = 0.0
    kw = dict(n_fft=256, hop_length=64, output_format="Magnitude", verbose=False)
    jl = jf.STFT(**kw)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jl(a)))(jnp.asarray(x)))
    assert np.isfinite(want).all() and (want[:, :1800] == 0).all()
    xt = torch.from_numpy(x).requires_grad_()
    tf.STFT(device="cpu", **kw)(xt).sum().backward()
    _close(xt.grad, want)
    assert torch.equal(xt.grad == 0, torch.from_numpy(want == 0))
    _no_fused_analysis(route)
    if route is not None:  # dx: the synthesis of the cotangent spectra (K3)
        assert route["synthesis_ola"] == 1


# -------------------------------------------------------------- features --
def _module_grads(layer, x, names, **kw):
    layer(x, **kw).sum().backward()
    return {k: getattr(layer, k).grad for k in names}


@pytest.mark.parametrize("fmt", ["Magnitude", "Complex", "Phase"])
def test_trainable_stft_gradients_match_jax(route, fmt):
    """tests/test_stft.py:128, in the three output formats. The magnitude's
    and the phase's gradients divide by |X|: a bin with a frame where |X| is
    near 0 turns with the last bits of the sums (here bin 18, where |X| drops
    to 1e-4 of its maximum, differs from JAX's by 1e-3), so they are held on
    the bins whose every frame has |X| >= 1e-3 max |X|, as the phase is in
    tests/test_torch_features.py."""
    x = np.random.RandomState(8).randn(1, 4096).astype(np.float32)
    kw = dict(n_fft=512, hop_length=256, trainable=True, verbose=False)
    jl = jf.STFT(output_format=fmt, **kw)
    want = jax.grad(lambda p: jnp.sum(jl.apply(p, x, output_format=fmt)))(
        jl.trainable_params())
    got = _module_grads(tf.STFT(output_format=fmt, device="cpu", **kw), x,
                        ["wsin", "wcos"])
    keep = slice(None)
    if fmt != "Complex":
        mag = np.asarray(jl.apply(None, x, output_format="Magnitude"))[0]
        keep = mag.min(axis=1) >= 1e-3 * mag.max()
        assert keep.sum() >= 250
    for k, g in got.items():
        _close(_np(g)[keep], np.asarray(want[k])[keep])
    _no_fused_analysis(route)


@pytest.mark.parametrize("cls", ["MelSpectrogram", "MFCC"])
def test_trainable_mel_and_mfcc_gradients_match_jax(route, cls):
    """tests/test_mel.py:117, and the MFCC over the same MelSpectrogram."""
    x = np.random.RandomState(5).randn(1, 8192).astype(np.float32)
    kw = dict(n_fft=1024, hop_length=512, n_mels=32, trainable_mel=True,
              trainable_STFT=True, verbose=False)
    jl = getattr(jf, cls)(**kw)
    want = jax.grad(lambda p: jnp.sum(jl.apply(p, x)))(jl.trainable_params())
    assert set(want) == {"mel_basis", "wsin", "wcos"}
    got = _module_grads(getattr(tf, cls)(device="cpu", **kw), x, sorted(want))
    for k, g in got.items():
        _close(g, want[k])
    _no_fused_analysis(route)


def test_trainable_cqt1992v2_gradients_match_jax(route):
    """The K6 envelope (24 bins of 4096 samples) under grad takes the pair."""
    kw = dict(sr=8000, fmin=55, n_bins=24, bins_per_octave=12, hop_length=256,
              trainable=True, verbose=False)
    jl = jf.CQT1992v2(**kw)
    tl = tf.CQT1992v2(device="cpu", **kw)
    assert td.kchunk_envelope(*tl.cqt_kernels_real.shape)
    x = np.random.RandomState(1).randn(1, 8192).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jl.apply(p, x)))(jl.trainable_params())
    got = _module_grads(tl, x, ["cqt_kernels_real", "cqt_kernels_imag"])
    for k, g in got.items():
        _close(g, want[k])
    _no_fused_analysis(route)


@pytest.mark.parametrize("wrt_spectrum", [False, True])
def test_istft_kernel_and_window_gradients_match_jax(route, wrt_spectrum):
    """tests/test_training.py:65's trainable iSTFT and input: its kernels'
    and window's gradients against ``jax.grad``, the window element 40
    against a finite difference; with ``wrt_spectrum`` also the spectrum's
    gradient (K3's backward through the pair). The loss is the distance to a
    seeded random signal: to the input itself, which the layer reconstructs,
    it is rounding noise."""
    n_fft, hop, length = 256, 64, 2048
    rng = np.random.RandomState(0)
    x = rng.randn(2, length).astype(np.float32)
    target = rng.randn(2, length).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, verbose=False)
    X = np.array(jf.STFT(output_format="Complex", **kw)(x))
    jl = jf.iSTFT(trainable_kernels=True, trainable_window=True, **kw)

    def jloss(p, spec):
        return jnp.sum((jl.apply(p, spec, onesided=True, length=length) - target) ** 2)
    want = jax.grad(jloss, argnums=(0, 1))(jl.trainable_params(), jnp.asarray(X))

    tl = tf.iSTFT(trainable_kernels=True, trainable_window=True, device="cpu", **kw)
    Xt = torch.from_numpy(X).requires_grad_(wrt_spectrum)

    def tloss():
        rec = tl(Xt, onesided=True, length=length)
        return ((rec - torch.from_numpy(target)) ** 2).sum()
    tloss().backward()
    for k in ("kernel_cos", "kernel_sin", "window_mask"):
        _close(getattr(tl, k).grad, want[0][k])
    if wrt_spectrum:
        _close(Xt.grad, want[1])
    if route is not None:
        assert route["synthesis_ola"] == 1
        assert route["framed_pair"] == int(wrt_spectrum)
    eps, i = 1e-3, 40
    with torch.no_grad():
        tl.window_mask[i] += eps
        up = float(tloss())
        tl.window_mask[i] -= 2 * eps
        down = float(tloss())
    fd = (up - down) / (2 * eps)
    assert np.isclose(fd, float(tl.window_mask.grad[i]), rtol=5e-2, atol=1e-2)


# ------------------------------------------------------------ train_step --
def _task_batch(seed, batch=8, sr=4000, dur=0.25, n_classes=4):
    """tests/test_training.py:15: class k is a tone at (k+1)*400 Hz in noise,
    drawn with numpy."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, batch)
    t = np.arange(int(sr * dur)) / sr
    clean = np.sin(2 * np.pi * (labels[:, None] + 1) * 400.0 * t[None, :])
    return (clean + 0.7 * rng.randn(*clean.shape)).astype(np.float32), labels


@pytest.mark.parametrize("cfg,lr", [
    # __graft_entry__.py:13-16, the entry config, at the default rate
    (dict(n_classes=10, sr=16000, n_fft=1024, hop_length=256, n_mels=64), 1e-3),
    # tests/test_training.py:80-90
    (dict(n_classes=4, sr=4000, n_fft=256, hop_length=64, n_mels=24), 1e-2),
], ids=["entry", "task"])
def test_train_step_matches_jax(route, cfg, lr):
    """One SGD step: the loss and every updated parameter within 1e-4 of
    JAX's ``train_step``, every parameter moved, the model's own tensors
    untouched, and on the kernel route no K3 (the waveform needs no
    gradient) and no K2 (the pair serves the differentiated forward)."""
    if cfg["sr"] == 16000:
        x = np.random.RandomState(0).randn(4, 16000).astype(np.float32)
        labels = np.array([0, 3, 7, 9])
    else:
        x, labels = _task_batch(1)
    jm = JClassifier(**cfg)
    j_loss, j_new = j_train_step(jm, jm.init_params, jnp.asarray(x),
                                 jnp.asarray(labels), lr=lr)
    tm = SpectrogramClassifier(device="cpu", **cfg)
    before = {k: v.detach().clone() for k, v in tm.init_params.items()}
    loss, new = train_step(tm, tm.init_params, torch.from_numpy(x),
                           torch.from_numpy(labels), lr=lr)
    assert abs(float(loss) - float(j_loss)) <= TOL * abs(float(j_loss))
    assert set(new) == set(j_new)
    for k, v in new.items():
        assert v.grad_fn is None and not v.requires_grad
        _close(v, j_new[k])
        assert float((v - before[k]).abs().max()) > 0, k
        assert torch.equal(getattr(tm, k), before[k]) and getattr(tm, k).grad is None
    _no_fused_analysis(route)
    if route is not None:
        assert route["synthesis_ola"] == 0


def test_classifier_gradients_match_jax(route):
    """The gradients ``train_step`` takes its step on, against
    ``jax.grad(loss_fn)`` at the entry config."""
    cfg = dict(n_classes=10, sr=16000, n_fft=1024, hop_length=256, n_mels=64)
    x = np.random.RandomState(0).randn(4, 16000).astype(np.float32)
    labels = np.array([0, 3, 7, 9])
    jm = JClassifier(**cfg)
    want = jax.grad(jm.loss_fn)(jm.init_params, jnp.asarray(x), jnp.asarray(labels))
    tm = SpectrogramClassifier(device="cpu", **cfg)
    params = tm.init_params
    got = torch.autograd.grad(tm.loss_fn(params, torch.from_numpy(x), labels),
                              list(params.values()))
    for k, g in zip(params, got):
        _close(g, want[k])
    _no_fused_analysis(route)


def test_fast_mode_gradients_stay_near_fp32(route):
    """bf16 storage: the classifier's gradients within 5e-2 of fp32's."""
    cfg = dict(n_classes=4, sr=4000, n_fft=256, hop_length=64, n_mels=24)
    x, labels = _task_batch(2)
    tm = SpectrogramClassifier(device="cpu", **cfg)
    params = tm.init_params

    def grads():
        return torch.autograd.grad(tm.loss_fn(params, torch.from_numpy(x), labels),
                                   list(params.values()))
    ref = grads()
    with config.fast_mode():
        fast = grads()
    for g, r in zip(fast, ref):
        assert 0 < _rel_err(g, r) <= FAST_TOL
