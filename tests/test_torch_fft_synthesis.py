"""K3's FFT route: the recognition of a transform's frozen Fourier synthesis
factors, the plain mirror of the kernel's arithmetic, and the route each
call takes; then, marked ``cuda`` (skipped without a card), the kernel
itself.

No JAX here: the cases marked ``cuda`` run on the card with
``python -m pytest tests/test_torch_fft_synthesis.py -q --noconftest``.
The CPU cases compare with float64 numpy and the dense plain version;
``tests/test_torch_griffin_lim.py`` holds the route against the JAX
package's iSTFT and Griffin-Lim.
"""
import contextlib

import numpy as np
import pytest
import torch

from nnaudio_tpu_torch import config, features, streaming
from nnaudio_tpu_torch.ops import framed_kernels as fk


def _rel(got, want):
    """Relative L2 error, in float64."""
    got, want = (np.asarray((a.detach().cpu() if isinstance(a, torch.Tensor) else a),
                            np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _spectra(b, n_fft, t, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (b, n_fft // 2 + 1, t)
    return (torch.randn(shape, generator=g, device=device),
            torch.randn(shape, generator=g, device=device))


def _f64_synthesis(sre, sim, window, hop):
    """OLA(window * irfft(Re + i Im)) in float64 numpy."""
    spec = sre.detach().cpu().double().numpy() + 1j * sim.detach().cpu().double().numpy()
    n_fft = 2 * (spec.shape[1] - 1)
    frames = np.fft.irfft(spec.transpose(0, 2, 1), n_fft) * window.detach().cpu().double().numpy()
    b, t = frames.shape[:2]
    out = np.zeros((b, n_fft + hop * (t - 1)))
    for k in range(t):
        out[:, k * hop:k * hop + n_fft] += frames[:, k]
    return out


def _kernels(n_fft, window):
    """The dense K3 kernels of an iSTFT: the Hermitian-weighted Fourier basis
    times window / N, made in float64 and rounded once."""
    f = n_fft // 2 + 1
    k = torch.arange(n_fft, dtype=torch.float64)
    turn = (torch.arange(f, dtype=torch.float64)[:, None] * k % n_fft) * (2 * np.pi / n_fft)
    wt = torch.full((f, 1), 2.0, dtype=torch.float64)
    wt[0] = wt[-1] = 1.0
    w = window.double() / n_fft
    return (wt * torch.cos(turn) * w).float(), (wt * torch.sin(turn) * w).float()


@pytest.fixture
def plan_builds(monkeypatch):
    """The plans built while the test runs (each call of
    build_synthesis_fft_plan)."""
    built = []
    real = fk.build_synthesis_fft_plan

    def build_plan(*ops):
        built.append(real(*ops))
        return built[-1]
    monkeypatch.setattr(fk, "build_synthesis_fft_plan", build_plan)
    return built


@contextlib.contextmanager
def _kernel_route():
    """Every wrapper takes the branch of a CUDA tensor; each launcher
    computes its plain version, and K3's two are counted."""
    calls = {"synthesis_ola": 0, "synthesis_ola_fft": 0}

    def count(name, plain):
        def run(*args):
            calls[name] += 1
            return plain(*args)
        return run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "_on_card", lambda t: True)
        mp.setattr(fk, "_launch_pair", fk.framed_pair_plain)
        mp.setattr(fk, "_launch_gl_step", fk.gl_step_plain)
        mp.setattr(fk, "_launch_gl_step_fft", lambda *args: fk.gl_step_fft_plain(*args[:-1]))
        mp.setattr(fk, "_launch_synthesis", count("synthesis_ola", fk.synthesis_ola_plain))
        mp.setattr(fk, "_launch_synthesis_fft", count(
            "synthesis_ola_fft",
            lambda sre, sim, hop, plan: fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop)))
        mp.setattr(fk, "_launch_nnls", lambda *args: fk.nnls_banded_plain(*args[:-1]))
        yield calls


# --------------------------------------------------------------- recognition --
def _factors(which, n_fft, **kw):
    """Whether the transform's kernels carry the Hermitian weights, and the
    three factors of its synthesis products."""
    if which == "Griffin_Lim":
        t = features.Griffin_Lim(n_fft=n_fft, device="cpu", **kw)
        return True, (t.kernel_cos_inv, t.kernel_sin_inv, t.window_mask)
    if which == "InverseMelSpectrogram":
        t = features.InverseMelSpectrogram(n_fft=n_fft, n_mels=8, verbose=False, device="cpu",
                                           **kw).griffin_lim
        return True, (t.kernel_cos_inv, t.kernel_sin_inv, t.window_mask)
    if which == "STFT.inverse":
        t = features.STFT(n_fft=n_fft, iSTFT=True, verbose=False, device="cpu", **kw)
        return False, (t.kernel_cos_inv, t.kernel_sin_inv, t.window_mask)
    t = features.iSTFT(n_fft=n_fft, verbose=False, device="cpu", **kw)
    return False, (t.kernel_cos, t.kernel_sin, t.window_mask)


def _plan(weighted, kc, ks, w):
    """The route's plan for a call on the products of these factors, made
    anew (as each iSTFT and Griffin-Lim call makes them)."""
    return fk.synthesis_fft_plan(*fk.synthesis_kernels(kc, ks, w, weighted))


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 4096])
@pytest.mark.parametrize("which", ["Griffin_Lim", "InverseMelSpectrogram", "iSTFT",
                                   "STFT.inverse"])
def test_the_transforms_synthesis_factors_are_recognised(which, n_fft):
    weighted, (kc, ks, w) = _factors(which, n_fft)
    plan = _plan(weighted, kc, ks, w)
    assert plan is not None and _plan(weighted, kc, ks, w) is plan
    assert torch.equal(plan.scale, w / n_fft)
    assert torch.equal(plan.twiddle, fk.fft_twiddles(n_fft))
    assert torch.equal(plan.edge, fk.synthesis_edge(n_fft))


@pytest.mark.parametrize("kw", [dict(window="hamming"), dict(win_length=700)])
def test_other_windows_are_recognised(kw):
    weighted, (kc, ks, w) = _factors("Griffin_Lim", 1024, **kw)
    assert _plan(weighted, kc, ks, w) is not None
    weighted, (kc, ks, w) = _factors("iSTFT", 1024, **kw)
    assert _plan(weighted, kc, ks, w) is not None


def test_the_streams_factors_are_recognised():
    s = streaming.StreamingiSTFT(n_fft=1024, hop_length=256, padding="same", device="cpu")
    plan = fk.synthesis_fft_plan(s._kc, s._ks)
    assert plan is not None and torch.equal(plan.scale, s._window / 1024)


@pytest.mark.parametrize("case", ["entry of kernel_cos", "entry of kernel_sin", "nan",
                                  "n_fft 400", "unweighted rows", "weighted rows",
                                  "window length", "inverse CQT dual bank"])
def test_other_factors_are_not_recognised(case):
    if case == "inverse CQT dual bank":
        cqt = features.CQT1992v2(sr=22050, hop_length=128, fmin=220, n_bins=24,
                                 output_format="Complex", verbose=False, device="cpu")
        kc, ks = cqt._dual_kernels("librosa", 1e-3)
        w = torch.ones(kc.shape[1])
        assert fk.build_synthesis_fft_plan(kc, ks, w, False) is None
        assert fk.build_synthesis_fft_plan(kc, ks, w, True) is None
        return
    n_fft = 400 if case == "n_fft 400" else 512
    which = "Griffin_Lim" if case == "unweighted rows" else "iSTFT"
    _, (kc, ks, w) = _factors(which, n_fft)
    kc, ks, w = kc.clone(), ks.clone(), w.clone()
    weighted = case == "weighted rows"
    if case == "entry of kernel_cos":
        kc[7, 100] *= 1.001
    elif case == "entry of kernel_sin":
        ks[200, 33] += 1e-4
    elif case == "nan":
        kc[3, 3] = float("nan")
    elif case == "window length":
        w = w[:-1]
    assert fk.build_synthesis_fft_plan(kc, ks, w, weighted) is None


def test_a_trainable_basis_or_window_or_bf16_storage_is_never_checked(plan_builds):
    _, (kc, ks, w) = _factors("iSTFT", 512)
    grads = [t.clone().requires_grad_() for t in (kc, ks, w)]
    fk.mark_own(*grads)  # marked, so that only the grad keeps them from the check
    assert _plan(False, grads[0], ks, w) is None
    assert _plan(False, kc, grads[1], w) is None
    assert _plan(False, kc, ks, grads[2]) is None
    for kw in (dict(trainable_kernels=True), dict(trainable_window=True)):
        layer = features.iSTFT(n_fft=512, verbose=False, device="cpu", **kw)
        assert _plan(False, layer.kernel_cos, layer.kernel_sin, layer.window_mask) is None
    with config.fast_mode():
        assert _plan(False, kc, ks, w) is None
    assert plan_builds == []


def test_the_verdict_is_kept_until_a_factor_changes(plan_builds):
    gl = features.Griffin_Lim(n_fft=512, hop_length=128, device="cpu")
    ops = gl.kernel_cos_inv, gl.kernel_sin_inv, gl.window_mask
    first = _plan(True, *ops)
    assert first is not None and _plan(True, *ops) is first and len(plan_builds) == 1
    with torch.no_grad():
        gl.kernel_sin_inv[5, 9] += 0.5  # an in-place edit: checked again, and refused
    assert _plan(True, *ops) is None and len(plan_builds) == 2
    gl.load_state_dict(features.Griffin_Lim(n_fft=512, hop_length=128,
                                            device="cpu").state_dict())
    assert _plan(True, *ops) is not None and len(plan_builds) == 3
    with torch.no_grad():
        gl.window_mask.mul_(0.5)  # another window: a new scale
    assert torch.equal(_plan(True, *ops).scale, gl.window_mask / 512)
    assert len(plan_builds) == 4


# ------------------------------------------------------------------ mirror --
@pytest.mark.parametrize("n_fft", [64, 128, 256, 1024, 4096, 8192])
def test_the_mirrors_inverse_real_fft_is_the_inverse_dft(n_fft):
    """irfft_plain is N times numpy's irfft, the imaginary parts of DC and
    Nyquist unread."""
    rng = np.random.RandomState(n_fft)
    x = (rng.randn(3, n_fft // 2 + 1) + 1j * rng.randn(3, n_fft // 2 + 1)).astype(np.complex64)
    got = fk.irfft_plain(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    want = np.fft.irfft(x.astype(np.complex128), n_fft) * n_fft
    assert _rel(got, want) < 4e-7


@pytest.mark.parametrize("n_fft,hop,t", [(64, 16, 5), (256, 64, 1), (512, 127, 9),
                                         (1024, 256, 4), (1024, 1024, 3), (2048, 1, 3),
                                         (4096, 1001, 6)])
def test_the_mirror_matches_a_float64_synthesis_and_the_dense_plain_version(n_fft, hop, t):
    window = torch.hann_window(n_fft, periodic=True)
    sre, sim = _spectra(2, n_fft, t, seed=n_fft + hop)
    got = fk.synthesis_ola_fft_plain(sre, sim, window / n_fft, hop)
    kc, ks = _kernels(n_fft, window)
    assert got.shape == (2, n_fft + hop * (t - 1))
    assert _rel(got, fk.synthesis_ola_plain(sre, sim, kc, ks, hop)) <= 2e-6
    assert _rel(got, _f64_synthesis(sre, sim, window, hop)) <= 1e-6


def test_the_mirror_reads_any_strides():
    """The halves of a (B, F, T, 2) stack give the planes' samples."""
    X = torch.randn(2, 257, 7, 2, generator=torch.Generator().manual_seed(1))
    scale = torch.hann_window(512, periodic=True) / 512
    got = fk.synthesis_ola_fft_plain(X[..., 0], X[..., 1], scale, 128)
    want = fk.synthesis_ola_fft_plain(X[..., 0].contiguous(), X[..., 1].contiguous(), scale, 128)
    assert torch.equal(got, want)


def _edge_error(y, spec_re, spec_im):
    """|y - irfft| at samples 1 and N - 1 of each frame, in fp32 units of the
    float64 value (plus 2^-40 of the frame's largest sample)."""
    spec = spec_re.double().numpy() + 1j * spec_im.double().numpy()
    n = 2 * (spec.shape[-1] - 1)
    want = np.fft.irfft(spec, n) * n
    got = y.double().numpy()
    edge = [1, n - 1]
    floor = 2.0 ** -40 * np.abs(want).max(-1, keepdims=True)
    return np.abs(got[..., edge] - want[..., edge]) / (2.0 ** -24 * np.abs(want[..., edge]) + floor)


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 8192])
def test_the_mirrors_edge_samples_are_rounded_once(n_fft):
    """Samples 1 and N - 1, where a tapering window is smallest, are the
    float64 sums rounded once: within an fp32 unit of their own value, not of
    the frame's largest sample, as the FFT's other samples are."""
    g = torch.Generator().manual_seed(n_fft)
    re, im = (torch.randn(6, n_fft // 2 + 1, generator=g) for _ in range(2))
    assert _edge_error(fk.irfft_plain(re, im), re, im).max() <= 1.0


# ------------------------------------------------------------------- route --
def _istft_input(n_fft, hop, b=2, t=24, seed=2):
    x = np.random.RandomState(seed).randn(b, n_fft + hop * (t - 1)).astype(np.float32)
    return features.STFT(n_fft=n_fft, hop_length=hop, output_format="Complex",
                         verbose=False, device="cpu")(x)


@pytest.mark.parametrize("case,route", [("Griffin_Lim highest", "synthesis_ola_fft"),
                                        ("iSTFT", "synthesis_ola_fft"),
                                        ("STFT.inverse", "synthesis_ola_fft"),
                                        ("iSTFT full spectrum", "synthesis_ola"),
                                        ("iSTFT trainable", "synthesis_ola"),
                                        ("iSTFT n_fft 400", "synthesis_ola"),
                                        ("CQT1992v2.inverse", "synthesis_ola")])
def test_each_synthesis_takes_its_route(case, route):
    n_fft, hop = (400, 100) if case.endswith("400") else (512, 128)
    if case.startswith("Griffin_Lim"):
        layer = features.Griffin_Lim(n_fft=n_fft, hop_length=hop, n_iter=3,
                                     iter_precision="highest", device="cpu")
        S = _istft_input(n_fft, hop).norm(dim=-1)
        phase = torch.rand(S.shape, generator=torch.Generator().manual_seed(3))

        def call():
            return layer(S, rand_phase=phase)
        launches = 4
    elif case == "CQT1992v2.inverse":
        cqt = features.CQT1992v2(sr=22050, hop_length=128, fmin=220, n_bins=24,
                                 output_format="Complex", verbose=False, device="cpu")
        X = cqt(torch.randn(2, 8192, generator=torch.Generator().manual_seed(4)))

        def call():
            return cqt.inverse(X)
        launches = 1
    else:
        X = _istft_input(n_fft, hop)
        if case == "STFT.inverse":
            layer = features.STFT(n_fft=n_fft, hop_length=hop, iSTFT=True, verbose=False,
                                  device="cpu")

            def call():
                return layer.inverse(X)
        else:
            layer = features.iSTFT(n_fft=n_fft, hop_length=hop, verbose=False, device="cpu",
                                   trainable_kernels=case == "iSTFT trainable")
            full = case == "iSTFT full spectrum"
            spec = torch.cat((X, X[:, 1:-1].flip(1) * torch.tensor([1.0, -1.0])), 1) if full else X

            def call():
                return layer(spec, onesided=not full)
        launches = 1
    with torch.no_grad():
        want = call()
        with _kernel_route() as calls:
            got = call()
    assert calls == {k: launches * (k == route) for k in calls}
    assert _rel(got, want) <= 1e-5


def test_griffin_lims_bf16_loop_takes_dense_k3_and_its_last_synthesis_the_route():
    """With ``iter_precision="default"`` the loop runs in bf16 storage (dense
    K3, unchecked); the final synthesis at the ambient fp32 takes the route."""
    gl = features.Griffin_Lim(n_fft=512, hop_length=128, n_iter=3, device="cpu")
    S = _istft_input(512, 128).norm(dim=-1)
    with torch.no_grad(), _kernel_route() as calls:
        gl(S)
    assert calls == {"synthesis_ola": 3, "synthesis_ola_fft": 1}


@pytest.mark.parametrize("override", ["kernel_cos", "kernel_sin", "window_mask"])
def test_a_factor_passed_in_takes_dense_k3_unchecked(plan_builds, override):
    layer = features.iSTFT(n_fft=512, hop_length=128, verbose=False, device="cpu")
    X = _istft_input(512, 128)
    with torch.no_grad(), _kernel_route() as calls:
        own = layer(X, onesided=True)
        got = layer.apply({override: getattr(layer, override).clone()}, X, onesided=True)
    assert calls == {"synthesis_ola": 1, "synthesis_ola_fft": 1}
    assert len(plan_builds) == 1
    assert _rel(got, own) <= 1e-5


def test_griffin_lim_on_a_basis_passed_in_takes_dense_k3_unchecked(plan_builds):
    gl = features.Griffin_Lim(n_fft=512, hop_length=128, n_iter=2, iter_precision="highest",
                              device="cpu")
    S = _istft_input(512, 128).norm(dim=-1)
    phase = torch.rand(S.shape, generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), _kernel_route() as calls:
        gl.apply({"kernel_cos_inv": gl.kernel_cos_inv.clone()}, S, rand_phase=phase)
    assert calls == {"synthesis_ola": 3, "synthesis_ola_fft": 0} and plan_builds == []


def test_the_k3_route_is_counted_while_tracing():
    from torch.profiler import ProfilerActivity, profile

    from nnaudio_tpu_torch.utils import profiling

    layer = features.iSTFT(n_fft=512, hop_length=128, verbose=False, device="cpu")
    X = _istft_input(512, 128)
    with _kernel_route(), torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            layer(X, onesided=True)
        fk.synthesis_ola(X[..., 0], X[..., 1], torch.randn(257, 512), torch.randn(257, 512), 128)
    table = profiling.span_table()
    assert table["nnaudio.route.K3.fft"].count == 3
    assert table["nnaudio.route.K3.dense"].count == 1
    assert table["nnaudio.wrap.K3"].count == 4


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (1024, 512), (1024, 301), (512, 127)])
@pytest.mark.parametrize("padding", ["none", "same"])
def test_the_stream_on_the_route_equals_the_offline_istft(n_fft, hop, padding):
    """concat(steps..., flush()) of chunks of 1-9 frames, one K3 a step on its
    FFT route, equals the offline iSTFT(center=False) on the route (less the
    ``"same"`` trim at both ends), at the iSTFT tolerances of
    tests/test_torch_streaming.py: 1e-5 of the largest sample away from the
    edges, 2e-3 at them."""
    t_total = 40
    x = np.random.RandomState(hop).randn(2, (t_total - 1) * hop + n_fft).astype(np.float32)
    X = features.STFT(n_fft=n_fft, hop_length=hop, center=False, output_format="Complex",
                      verbose=False, device="cpu")(x)
    s = streaming.StreamingiSTFT(n_fft=n_fft, hop_length=hop, padding=padding, device="cpu")
    with torch.no_grad(), _kernel_route() as calls:
        want = features.iSTFT(n_fft=n_fft, hop_length=hop, center=False, verbose=False,
                              device="cpu")(X, onesided=True).numpy()
        state, outs, pos, steps = s.init_state(2), [], 0, 0
        for size in (1, 4, 9, 2, 7, 3) * 4:
            size = min(size, t_total - pos)
            if size == 0:
                break
            state, out = s.step(state, X[:, :, pos:pos + size])
            outs.append(out.numpy())
            pos, steps = pos + size, steps + 1
        outs.append(s.flush(state).numpy())
    assert calls == {"synthesis_ola": 0, "synthesis_ola_fft": steps + 1}
    got = np.concatenate(outs, 1)
    if padding == "same":
        trim = (n_fft - hop) // 2
        want = want[:, trim:want.shape[1] - trim]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:, n_fft:-n_fft], want[:, n_fft:-n_fft], atol=1e-5 * scale)
    np.testing.assert_allclose(got, want, atol=2e-3 * scale)


# -------------------------------------------------------------------- card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_kernel_takes_every_n_fft_of_the_route(cuda):
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
        assert fk._synthesis_kernel_takes(n)
    assert not fk._synthesis_kernel_takes(400) and not fk._synthesis_kernel_takes(16384)


def _card_plan(cuda, n_fft):
    window = torch.hann_window(n_fft, periodic=True, device=cuda)
    plan = fk.SynthesisFFTPlan(scale=window / n_fft, twiddle=fk.fft_twiddles(n_fft, cuda),
                               edge=fk.synthesis_edge(n_fft, cuda))
    return plan, window


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["planes", "stack"])
@pytest.mark.parametrize("n_fft,hop,b,t", [
    (1024, 256, 32, 862),   # the Griffin-Lim cell's call
    (1024, 256, 128, 4),    # the synthesis stream's step
    (64, 16, 3, 16), (128, 37, 2, 1), (256, 64, 5, 4), (512, 127, 4, 16),
    (2048, 512, 3, 862), (2048, 2048, 2, 16), (4096, 1001, 2, 4), (8192, 2048, 2, 16),
    (8192, 8192, 1, 1), (1024, 1, 1, 4),
])
def test_the_kernel_matches_its_mirror_and_dense_k3(cuda, layout, n_fft, hop, b, t):
    plan, window = _card_plan(cuda, n_fft)
    sre, sim = _spectra(b, n_fft, t, seed=hop, device=cuda)
    if layout == "stack":  # the halves of a (B, F, T, 2) stack: stride 2 along T
        X = torch.stack((sre, sim), -1)
        sre, sim = X[..., 0], X[..., 1]
        assert sre.stride(-1) == 2
    before = fk.LAUNCHES["synthesis_ola_fft"]
    got = fk._launch_synthesis_fft(sre, sim, hop, plan)
    twice = fk._launch_synthesis_fft(sre, sim, hop, plan)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["synthesis_ola_fft"] == before + 2
    assert torch.equal(got, twice)
    assert _rel(got, fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop)) <= 1e-6
    assert _rel(got, _f64_synthesis(sre, sim, window, hop)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [64, 1024, 8192])
def test_the_kernels_edge_samples_are_rounded_once(cuda, n_fft):
    """With a unit scale and hop N the kernel's output is each frame's
    unnormalised inverse: samples 1 and N - 1 of every frame within an fp32
    unit of their own value, and of the mirror's (which adds the same float64
    terms in another order)."""
    plan = fk.SynthesisFFTPlan(scale=torch.ones(n_fft, device=cuda),
                               twiddle=fk.fft_twiddles(n_fft, cuda),
                               edge=fk.synthesis_edge(n_fft, cuda))
    sre, sim = _spectra(3, n_fft, 5, seed=7, device=cuda)
    got = fk._launch_synthesis_fft(sre, sim, n_fft, plan).cpu().reshape(3, 5, n_fft)
    re, im = (a.cpu().transpose(1, 2) for a in (sre, sim))
    im[..., 0] = im[..., -1] = 0.0
    assert _edge_error(got, re, im).max() <= 1.0
    edge = [1, n_fft - 1]
    mirror = fk.irfft_plain(re, im)[..., edge].numpy()
    assert (np.abs(got[..., edge].numpy() - mirror) <= np.spacing(np.abs(mirror))).all()


@pytest.mark.cuda
def test_the_launches_and_the_trace_show_the_route(cuda):
    from torch.profiler import ProfilerActivity, profile

    from nnaudio_tpu_torch.utils import profiling

    X = _istft_input(1024, 256, b=4, t=30).to(cuda)
    istft = features.iSTFT(n_fft=1024, hop_length=256, verbose=False, device=cuda)
    trainable = features.iSTFT(n_fft=1024, hop_length=256, trainable_kernels=True,
                               verbose=False, device=cuda)
    odd = features.iSTFT(n_fft=400, hop_length=100, verbose=False, device=cuda)
    X400 = _istft_input(400, 100, b=4, t=30).to(cuda)
    before = dict(fk.LAUNCHES)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        fast = istft(X, onesided=True)
        slow = trainable(X, onesided=True)
        odd(X400, onesided=True)
        with config.fast_mode():
            istft(X, onesided=True)
    torch.cuda.synchronize()
    launched = {k: fk.LAUNCHES[k] - before[k] for k in ("synthesis_ola", "synthesis_ola_fft")}
    assert launched == {"synthesis_ola": 3, "synthesis_ola_fft": 1}
    table = profiling.span_table()
    assert table["nnaudio.route.K3.fft"].count == 1
    assert table["nnaudio.route.K3.dense"].count == 3
    assert _rel(fast, slow) <= 1e-5


@pytest.mark.cuda
def test_the_stream_on_the_card_takes_the_route_and_matches_the_offline_istft(cuda):
    n_fft, hop, t_total = 1024, 256, 64
    X = _istft_input(n_fft, hop, b=8, t=t_total)[:, :, :t_total].to(cuda)
    s = streaming.StreamingiSTFT(n_fft=n_fft, hop_length=hop, padding="same", device=cuda)
    before = fk.LAUNCHES["synthesis_ola_fft"]
    with torch.no_grad():
        want = features.iSTFT(n_fft=n_fft, hop_length=hop, center=False, verbose=False,
                              device=cuda)(X, onesided=True)
        state, outs = s.init_state(8), []
        for a in range(0, t_total, 4):
            state, out = s.step(state, X[:, :, a:a + 4])
            outs.append(out)
        outs.append(s.flush(state))
    torch.cuda.synchronize()
    assert fk.LAUNCHES["synthesis_ola_fft"] - before == t_total // 4 + 1
    trim = (n_fft - hop) // 2
    want = want[:, trim:want.shape[1] - trim]
    got = torch.cat(outs, 1)
    assert got.shape == want.shape and _rel(got, want) <= 1e-6
