"""K2's FFT route: the recognition of a frozen Fourier basis, the packed
bands, the plain mirror of the kernel's arithmetic, and the route each call
takes; then, marked ``cuda`` (skipped without a card), the kernel itself.

No JAX here: the cases marked ``cuda`` run on the card with
``python -m pytest tests/test_torch_fft_filterbank.py -q --noconftest``.
The CPU cases compare with float64 numpy.
"""
import contextlib
import re

import numpy as np
import pytest
import torch

from nnaudio_tpu_torch import config, features, models, streaming
from nnaudio_tpu_torch.filters import (chroma_filterbank, create_fourier_basis,
                                       gammatone_filterbank, mel_filterbank)
from nnaudio_tpu_torch.ops import build
from nnaudio_tpu_torch.ops import framed_kernels as fk


def _bases(n_fft, window="hann", win_length=None, **kw):
    stft = features.STFT(n_fft=n_fft, win_length=win_length, window=window,
                         output_format="Magnitude", verbose=False, device="cpu", **kw)
    return stft.wcos, stft.wsin


def _mel(n_fft, n_mels=128, sr=22050, htk=False):
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, 0.0, None, htk=htk, norm=1)).float()


def _rel(got, want):
    """Relative L2 error, in float64 (complex128 for complex arrays)."""
    got, want = (np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
                 for a in (got, want))
    got, want = got.astype(np.result_type(got, np.float64)), want.astype(
        np.result_type(want, np.float64))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def plan_builds(monkeypatch):
    """The plans built while the test runs (each call of build_fft_plan)."""
    built = []
    real = fk.build_fft_plan

    def build_plan(*ops):
        built.append(real(*ops))
        return built[-1]
    monkeypatch.setattr(fk, "build_fft_plan", build_plan)
    return built


# --------------------------------------------------------------- recognition --
@pytest.mark.parametrize("n_fft", [256, 400, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_the_stft_builders_bases_are_recognised(n_fft, window):
    wc, ws = _bases(n_fft, window)
    plan = fk.build_fft_plan(wc, ws, _mel(n_fft, 64))
    assert plan is not None
    assert torch.equal(plan.window, wc[0])
    assert plan.m == 64 and plan.vals.dtype == torch.float32


@pytest.mark.parametrize("n_fft,win_length", [(256, 200), (1024, 400), (2048, 1024)])
def test_a_window_shorter_than_n_fft_is_recognised(n_fft, win_length):
    wc, ws = _bases(n_fft, win_length=win_length)
    assert (wc[0] == 0).any()  # the window is padded with zeros to n_fft
    assert fk.build_fft_plan(wc, ws, _mel(n_fft, 40)) is not None


@pytest.mark.parametrize("case", ["entry of wcos", "entry of wsin", "nan", "n_fft 448",
                                  "n_fft 600", "freq_scale log", "freq_bins 100", "fb width"])
def test_other_bases_are_not_recognised(case):
    """Bases off the Fourier basis, and n_fft the route has no kernel for:
    448 = 7 x 64 and 600 = 3 x 200 (n_fft 400 = 2^4 5^2 is taken)."""
    n_fft = int(case.split()[1]) if case.startswith("n_fft") else 512
    kw = {"freq_scale log": dict(freq_scale="log", fmin=50, fmax=6000, sr=22050),
          "freq_bins 100": dict(freq_bins=100)}.get(case, {})
    wc, ws = (t.clone() for t in _bases(n_fft, **kw))
    fb = _mel(n_fft, 40)
    if case == "entry of wcos":
        wc[7, 100] *= 1.001
    elif case == "entry of wsin":
        ws[200, 33] += 1e-4
    elif case == "nan":
        wc[3, 3] = float("nan")
    elif case == "fb width":
        fb = fb[:, :-1]
    assert fk.build_fft_plan(wc, ws, fb) is None


def test_a_basis_that_requires_grad_or_bf16_storage_is_never_checked(plan_builds):
    wc, ws = _bases(512)
    fb = _mel(512, 40)
    fk.mark_own(fb)
    gc, gs = wc.clone().requires_grad_(), ws.clone().requires_grad_()
    fk.mark_own(gc, gs)  # marked, so that only the grad keeps them from the check
    assert fk.fft_plan(gc, ws, fb) is None
    assert fk.fft_plan(wc, gs, fb) is None
    with config.fast_mode():
        assert fk.fft_plan(wc, ws, fb) is None
    assert plan_builds == []


def test_the_verdict_is_kept_until_an_operand_changes(plan_builds):
    mel = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                  device="cpu")
    ops = mel.wcos, mel.wsin, mel.mel_basis
    first = fk.fft_plan(*ops)
    assert first is not None and fk.fft_plan(*ops) is first and len(plan_builds) == 1
    with torch.no_grad():
        mel.wcos[3, 7] += 0.5  # an in-place edit: checked again, and refused
    assert fk.fft_plan(*ops) is None and len(plan_builds) == 2
    assert fk.fft_plan(*ops) is None and len(plan_builds) == 2
    fresh = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                    device="cpu")
    mel.load_state_dict(fresh.state_dict())  # the Fourier basis again
    again = fk.fft_plan(*ops)
    assert again is not None and again is not first and len(plan_builds) == 3
    # a scaled window is a window; a scaled sine alone is not its Fourier basis
    mel.load_state_dict({k: v * 1.5 for k, v in fresh.state_dict().items()})
    assert fk.fft_plan(*ops) is not None and len(plan_builds) == 4
    mel.load_state_dict({k: v * 1.5 if k == "wsin" else v
                         for k, v in fresh.state_dict().items()})
    assert fk.fft_plan(*ops) is None and len(plan_builds) == 5
    with torch.no_grad():
        mel.mel_basis.mul_(2.0)  # a filterbank step packs the bands again
    mel.load_state_dict(fresh.state_dict())
    assert torch.equal(fk.fft_plan(*ops).vals, fk.filterbank_bands(mel.mel_basis)[2])
    other = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                    device="cpu")  # other tensors: built anew
    assert fk.fft_plan(other.wcos, other.wsin, other.mel_basis) is not None
    assert len(plan_builds) == 7


def test_an_stft_loaded_by_assignment_keeps_k2s_route(plan_builds):
    """``load_state_dict(assign=True)`` puts the snapshot's tensors in place
    of the STFT's own: they are its own now, and K2 takes its FFT route."""
    mel = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                  device="cpu")
    stft = mel.stft
    fresh = features.STFT(n_fft=512, hop_length=128, output_format="Magnitude",
                          verbose=False, device="cpu")
    stft.load_state_dict(fresh.state_dict(), assign=True)
    assert stft.wcos is not fresh.wcos and stft.wcos.data_ptr() == fresh.wcos.data_ptr()
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 4096).astype(np.float32))
    with _kernel_route() as calls, torch.no_grad():
        got = fk.framed_filterbank(x, stft.wcos, stft.wsin, mel.mel_basis, 128)
    assert calls == {"framed_filterbank": 0, "framed_filterbank_fft": 1}
    assert len(plan_builds) == 1
    want = fk.framed_filterbank_plain(x, stft.wcos, stft.wsin, mel.mel_basis, 128)
    assert _rel(got, want) <= 1e-5


# ------------------------------------------------------------------- bands --
def _dense(lo, off, vals, f):
    out = torch.zeros(lo.shape[0], f)
    for m in range(lo.shape[0]):
        n = int(off[m + 1] - off[m])
        out[m, int(lo[m]):int(lo[m]) + n] = vals[int(off[m]):int(off[m + 1])]
    return out


@pytest.mark.parametrize("bank", ["slaney", "htk", "gammatone", "chroma", "edited"])
def test_the_packed_bands_reproduce_the_filterbank(bank):
    n_fft, sr = 2048, 22050
    fb = {"slaney": lambda: _mel(n_fft),
          "htk": lambda: _mel(n_fft, htk=True),
          "gammatone": lambda: torch.from_numpy(
              gammatone_filterbank(sr, n_fft, 64, 20.0, 6000.0)).float(),
          "chroma": lambda: torch.from_numpy(chroma_filterbank(sr, n_fft)).float(),
          "edited": lambda: _mel(n_fft, 16)}[bank]()
    if bank == "edited":  # a row of zeros, and a zero inside a band
        fb[3] = 0.0
        fb[5, int(fb[5].nonzero()[1])] = 0.0
    lo, off, vals = fk.filterbank_bands(fb)
    assert torch.equal(_dense(lo, off, vals, fb.shape[1]), fb)
    assert int(off[-1]) == vals.numel() <= fb.numel()
    if bank == "slaney":
        assert vals.numel() == 2018  # of 128 x 1025
    if bank == "edited":
        assert int(off[4] - off[3]) == 0


# ----------------------------------------------------------------- mirror --
def test_the_twiddle_table_and_the_kernels_constants_agree():
    """cos32 in csrc/framed_fft.cu holds W_32's cosines as the table does."""
    src = (build.CSRC / "framed_fft.cu").read_text()
    body = src.split("constexpr float cos32(int t)", 1)[1].split(";", 1)[0]
    consts = [1.0] + [float.fromhex(h.rstrip("f"))
                      for h in re.findall(r"t == \d \? (0x[0-9a-fp.+-]+f)", body)]
    assert len(consts) == 8
    for n in (64, 2048, 8192):
        table = fk.fft_twiddles(n).double().numpy()
        for t in range(16):
            w = table[t * n // 32]
            if t <= 8:
                want = (consts[t] if t < 8 else 0.0, -consts[8 - t] if t > 0 else -0.0)
            else:
                want = (-consts[16 - t], -consts[t - 8])
            assert tuple(w) == pytest.approx(want, abs=0.0)


def test_the_radix_5_constants_and_the_mirrors_agree():
    """C5_1 ... S5_2 in csrc/framed_fft.cu hold the mirror's FFT_C5."""
    src = (build.CSRC / "framed_fft.cu").read_text()
    consts = dict(re.findall(r"([CS]5_[12]) = (-?0x[0-9a-fp.+-]+)f", src))
    got = tuple(float.fromhex(consts[k]) for k in ("C5_1", "C5_2", "S5_1", "S5_2"))
    assert got == fk.FFT_C5


@pytest.mark.parametrize("n,radices", [(400, [8, 5, 5]), (320, [8, 4, 5]), (800, [16, 5, 5]),
                                       (1600, [8, 4, 5, 5]), (500, [2, 5, 5, 5]),
                                       (8000, [8, 4, 5, 5, 5]), (2048, [32, 32])])
def test_the_route_takes_mixed_radix_n_in_passes_of_16_or_fewer_then_5(n, radices):
    assert fk.mixed_radix(n) == (n != 2048)
    assert fk.fft_radices(n // 2) == radices
    assert fk.fft_twiddles(n).shape[0] == fk.fft_pass_offsets(n // 2)[-1]
    assert not any(fk.mixed_radix(k) for k in (448, 600, 250, 60, 10000, 1024))


@pytest.mark.parametrize("h", [32, 64, 128, 256, 512, 1024, 2048, 4096, 160, 200, 400, 800])
def test_the_mirrors_complex_fft_is_the_dft(h):
    rng = np.random.RandomState(h)
    z = rng.randn(3, h) + 1j * rng.randn(3, h)
    table = fk.fft_twiddles(2 * h)
    assert table.shape[0] == fk.fft_pass_offsets(h)[-1]
    zr, zi = fk._fft_stockham(torch.from_numpy(z.real).float(),
                              torch.from_numpy(z.imag).float(), table)
    want = np.fft.fft(z.astype(np.complex64).astype(np.complex128))
    assert _rel(zr.numpy() + 1j * zi.numpy(), want) < 4e-7


@pytest.mark.parametrize("n_fft,hop,window", [(256, 61, "hann"), (1024, 255, "hamming"),
                                              (2048, 512, "hann"), (4096, 1001, "hann")] + [
    (n_fft, hop, "hann") for n_fft in (320, 400, 800, 1600) for hop in (160, 100, 441)])
def test_the_mirror_matches_a_float64_mel_and_the_dense_plain_version(n_fft, hop, window):
    """At the powers of two and at Whisper's n_fft and its kin (mixed radix):
    fp32's rounding through a few passes, 2e-6 of float64; 1e-5 of the dense
    plain version."""
    wc, ws = _bases(n_fft, window)
    fb = _mel(n_fft, 64)
    rng = np.random.RandomState(n_fft)
    x = rng.randn(2, n_fft + 9 * hop + 3).astype(np.float32)
    got = fk.framed_filterbank_fft_plain(torch.from_numpy(x), wc, ws, fb, hop).numpy()
    w = np.asarray(create_fourier_basis(n_fft, window=window).window_mask, np.float64)
    t = (x.shape[1] - n_fft) // hop + 1
    frames = np.stack([x[:, k * hop:k * hop + n_fft] for k in range(t)], 1).astype(np.float64)
    power = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    want = np.einsum("mf,btf->bmt", fb.double().numpy(), power)
    assert _rel(got, want) <= 2e-6
    dense = fk.framed_filterbank_plain(torch.from_numpy(x), wc, ws, fb, hop).numpy()
    assert _rel(got, dense) <= 1e-5


def test_a_whisper_basis_is_recognised():
    """WhisperLogMel's bases and its 128 x 201 Slaney bank (394 nonzero
    entries, none of its rows empty, the widest 9 columns) make a plan."""
    layer = features.WhisperLogMel(device="cpu")
    plan = fk.build_fft_plan(layer.wcos, layer.wsin, layer.mel_basis)
    assert plan is not None and plan.m == 128 and plan.vals.numel() == 394
    lo, off, _ = fk.filterbank_bands(layer.mel_basis)
    length = off[1:] - off[:-1]
    assert int(length.min()) >= 1 and int(length.max()) == 9
    assert plan.twiddle.shape[0] == fk.fft_pass_offsets(200)[-1]


def test_a_stream_at_n_fft_400_on_the_route_is_the_offline_mel():
    """StreamingMel at Whisper's n_fft 400, hop 160, on K2's route (its
    mirror): the steps' frames are the offline center=False Mel's, bit for
    bit, whatever the chunks."""
    kw = dict(sr=16000, n_fft=400, hop_length=160, n_mels=128, fmax=8000.0)
    s = streaming.StreamingMel(**kw, device="cpu")
    offline = features.MelSpectrogram(**kw, center=False, verbose=False, device="cpu")
    x = torch.from_numpy(np.random.RandomState(9).randn(3, 160 * 40).astype(np.float32))
    with _kernel_route() as calls, torch.no_grad():
        state, outs = s.init_state(3), []
        for a, b in ((0, 320), (320, 1600), (1600, 1760), (1760, 6400)):
            state, out = s.step(state, x[:, a:b])
            outs.append(out)
        want = offline(x)
    got = torch.cat(outs, 2)
    assert calls["framed_filterbank"] == 0 and calls["framed_filterbank_fft"] >= 4
    assert got.shape == want.shape and torch.equal(got, want)


def test_the_mirror_adds_eps_to_every_bin():
    wc, ws = _bases(256)
    fb = _mel(256, 16, sr=16000)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 256 + 64 * 5).astype(np.float32))
    base = fk.framed_filterbank_fft_plain(x, wc, ws, fb, 64)
    shifted = fk.framed_filterbank_fft_plain(x, wc, ws, fb, 64, eps=0.25)
    np.testing.assert_allclose(shifted - base, 0.25 * fb.sum(1)[None, :, None].expand_as(base),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ route --
@contextlib.contextmanager
def _kernel_route():
    """Every wrapper takes the branch of a CUDA tensor; each launcher
    computes its plain version and is counted."""
    calls = {"framed_filterbank": 0, "framed_filterbank_fft": 0}

    def count(name, plain):
        def run(*args):
            calls[name] += 1
            return plain(*args)
        return run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "_on_card", lambda t: True)
        mp.setattr(fk, "_launch_filterbank", count("framed_filterbank",
                                                   fk.framed_filterbank_plain))
        mp.setattr(fk, "_launch_filterbank_fft", count(
            "framed_filterbank_fft",
            lambda x, wc, ws, fb, hop, eps, plan: fk.framed_filterbank_fft_plain(
                x, wc, ws, fb, hop, eps)))
        yield calls


@pytest.mark.parametrize("case,route", [("frozen", "framed_filterbank_fft"),
                                        ("mfcc", "framed_filterbank_fft"),
                                        ("trainable STFT", "framed_filterbank"),
                                        ("random basis", "framed_filterbank"),
                                        ("n_fft 400", "framed_filterbank_fft"),
                                        ("n_fft 448", "framed_filterbank")])
def test_each_basis_takes_its_route(case, route):
    kw = dict(n_fft=int(case.split()[1]) if case.startswith("n_fft") else 512, hop_length=128,
              n_mels=40, verbose=False, device="cpu")
    if case == "mfcc":
        layer = features.MFCC(n_mfcc=13, **kw)
    else:
        layer = features.MelSpectrogram(trainable_STFT=case == "trainable STFT", **kw)
    if case == "random basis":
        with torch.no_grad():
            layer.wcos.normal_()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4096).astype(np.float32))
    want = layer(x)
    with _kernel_route() as calls, torch.no_grad():
        got = layer(x)
    assert calls == {k: int(k == route) for k in calls}
    assert _rel(got, want) <= 1e-5


def test_a_copy_keeps_the_route_and_the_tensors_stay_plain(tmp_path):
    """A copy of a transform (``copy.deepcopy``, unpickling) marks the
    copies of its tensors as its own, so it keeps K2's route; the mark is
    kept beside the tensors, not on them, so a transform's ``params`` save
    and load with ``weights_only`` as any tensors do."""
    import copy

    mel = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                  device="cpu")
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 4096).astype(np.float32))
    twin = copy.deepcopy(mel)
    assert twin.wcos is not mel.wcos
    with _kernel_route() as calls, torch.no_grad():
        got, want = twin(x), mel(x)
    assert calls == {"framed_filterbank": 0, "framed_filterbank_fft": 2}
    assert torch.equal(got, want)
    torch.save(mel.params, tmp_path / "params.pt")
    loaded = torch.load(tmp_path / "params.pt", weights_only=True)
    assert all(torch.equal(loaded[k], v) for k, v in mel.params.items())


@pytest.mark.parametrize("override", ["wcos", "wsin", "mel_basis"])
def test_a_tensor_passed_in_takes_dense_k2_unchecked(plan_builds, override):
    """A params override is not the transform's own tensor: it is never
    checked, even where it holds the same values."""
    mel = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                  device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 4096).astype(np.float32))
    with _kernel_route() as calls, torch.no_grad():
        own = mel(x)
        got = mel.apply({override: getattr(mel, override).clone()}, x)
    assert calls == {"framed_filterbank": 1, "framed_filterbank_fft": 1}
    assert len(plan_builds) == 1
    assert _rel(got, own) <= 1e-5


def test_a_classifier_on_a_steps_new_params_takes_dense_k2_unchecked(plan_builds):
    """The new parameters of a train step are plain tensors that require no
    grad; evaluated under no_grad they take dense K2, with no check of the
    basis."""
    model = models.SpectrogramClassifier(n_classes=3, sr=8000, n_fft=256, hop_length=64,
                                         n_mels=16, device="cpu")
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 2048).astype(np.float32))
    _, new = models.train_step(model, model.init_params, x, torch.tensor([0, 2]))
    assert not any(v.requires_grad for v in new.values())
    want = model(new, x)
    with _kernel_route() as calls, torch.no_grad():
        got = model(new, x)
        model(None, x)
    assert calls == {"framed_filterbank": 2, "framed_filterbank_fft": 0}
    assert plan_builds == []
    assert _rel(got, want) <= 1e-5


def test_the_fft_route_is_counted_while_tracing():
    from torch.profiler import ProfilerActivity, profile

    from nnaudio_tpu_torch.utils import profiling

    mel = features.MelSpectrogram(n_fft=512, hop_length=128, n_mels=40, verbose=False,
                                  device="cpu")
    x = torch.randn(2, 4096)
    with _kernel_route(), torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            mel(x)
        with torch.no_grad():
            fk.framed_filterbank(x, torch.randn(257, 512), torch.randn(257, 512),
                                 mel.mel_basis, 128)
    table = profiling.span_table()
    assert table["nnaudio.route.K2.fft"].count == 3
    assert table["nnaudio.route.K2.dense"].count == 1
    assert table["nnaudio.wrap.K2"].count == 4
    assert table["nnaudio.route.K2.fft"].outer == table["nnaudio.route.K2.fft"].self_ns == 0


# ------------------------------------------------------------------- card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_blocks_shared_memory_fits_the_mel_defaults(cuda):
    """The kernel owns its block's shape: it takes every n_fft of the route
    at 256 rows, reads fft_twiddles' table, and refuses a width it has no
    instance for or rows past its shared memory."""
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 80, 320, 400, 500, 1600, 8000):
        assert fk._kernel_takes(n, 256)
    assert not fk._kernel_takes(448, 128) and not fk._kernel_takes(600, 128)
    assert not fk._kernel_takes(2048, 0)
    assert not fk._kernel_takes(8192, 1 << 16) and not fk._kernel_takes(8000, 1 << 16)


def _card_case(cuda, n_fft, m, b, length, seed=0):
    wc, ws = (t.to(cuda) for t in _bases(n_fft))
    fb = _mel(n_fft, m).to(cuda)
    fk.mark_own(wc, ws, fb)  # a transform's own tensors, as the route wants them
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(b, length, generator=g, device=cuda), wc, ws, fb


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,m,b,length,hop", [
    (2048, 128, 32, 220500 + 2048, 512),   # a 10 s call of the Mel cells
    (2048, 128, 32, 1536 + 2048, 512),     # a stream step of 32
    (256, 40, 3, 256 + 61 * 37 + 5, 61),
    (1024, 80, 5, 1024 + 255 * 29 + 11, 255),
    (4096, 128, 2, 4096 + 1001 * 13, 1001),
])
def test_the_kernel_matches_its_mirror_and_dense_k2(cuda, n_fft, m, b, length, hop):
    x, wc, ws, fb = _card_case(cuda, n_fft, m, b, length)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.framed_filterbank(x, wc, ws, fb, hop)
        twice = fk.framed_filterbank(x, wc, ws, fb, hop)
        with fk.span("nnaudio.wrap.K2"):
            dense = fk._launch_filterbank(x, wc, ws, fb, hop, 0.0)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["framed_filterbank_fft"] == before["framed_filterbank_fft"] + 2
    assert torch.equal(got, twice)
    assert _rel(got.cpu(), fk.framed_filterbank_fft_plain(x, wc, ws, fb, hop).cpu()) <= 1e-6
    assert _rel(got.cpu(), dense.cpu()) <= 1e-5
    want = fk.framed_filterbank_plain(x.double(), wc.double(), ws.double(), fb.double(), hop)
    assert _rel(got.cpu(), want.cpu()) <= 2e-6


@pytest.mark.cuda
def test_the_stream_is_bit_equal_to_the_offline_mel_on_the_fft_route(cuda):
    kw = dict(sr=22050, n_fft=2048, hop_length=512, n_mels=128)
    s = streaming.StreamingMel(**kw, device=cuda)
    offline = features.MelSpectrogram(**kw, center=False, verbose=False, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(32, 2048 * 12, generator=g, device=cuda)
    before = fk.LAUNCHES["framed_filterbank_fft"]
    with torch.no_grad():
        state, outs = s.init_state(32), []
        for k in range(12):
            state, out = s.step(state, x[:, 2048 * k:2048 * (k + 1)])
            outs.append(out)
        want = offline(x)
    got = torch.cat(outs, 2)
    assert fk.LAUNCHES["framed_filterbank_fft"] - before >= 12
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", [("frozen", "framed_filterbank_fft"),
                                        ("trainable STFT", "framed_filterbank"),
                                        ("random basis", "framed_filterbank")])
def test_the_launches_show_the_route(cuda, case, route):
    mel = features.MelSpectrogram(trainable_STFT=case == "trainable STFT", verbose=False,
                                  device=cuda)
    if case == "random basis":
        with torch.no_grad():
            mel.wcos.normal_()
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        mel(torch.randn(4, 22050, device=cuda))
    torch.cuda.synchronize()
    launched = {k: fk.LAUNCHES[k] - before[k] for k in ("framed_filterbank",
                                                        "framed_filterbank_fft")}
    assert launched == {k: int(k == route) for k in launched}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [3001, 4])
def test_the_kernel_at_whispers_n_fft_matches_its_mirror_and_float64(cuda, t):
    """K2's mixed-radix kernel at WhisperLogMel's n_fft 400, hop 160, 128
    mels: a 30 s window's 3,001 frames (B=2) and a stream step's 4, against
    the mirror (1e-6: fp32 contracted otherwise), float64 (2e-6) and dense K2
    (1e-5); bit-equal runs, and each batch item alone gives its own bits."""
    layer = features.WhisperLogMel(device=cuda)
    wc, ws, fb = layer.wcos, layer.wsin, layer.mel_basis
    g = torch.Generator(device=cuda).manual_seed(t)
    x = torch.randn(2, 400 + 160 * (t - 1), generator=g, device=cuda)
    before = fk.LAUNCHES["framed_filterbank_fft"]
    with torch.no_grad():
        got = fk.framed_filterbank(x, wc, ws, fb, 160)
        twice = fk.framed_filterbank(x, wc, ws, fb, 160)
        alone = torch.cat([fk.framed_filterbank(x[i:i + 1], wc, ws, fb, 160) for i in range(2)])
        with fk.span("nnaudio.wrap.K2"):
            dense = fk._launch_filterbank(x, wc, ws, fb, 160, 0.0)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["framed_filterbank_fft"] == before + 4
    assert got.shape == (2, 128, t)
    assert torch.equal(got, twice) and torch.equal(got, alone)
    assert _rel(got.cpu(), fk.framed_filterbank_fft_plain(x, wc, ws, fb, 160).cpu()) <= 1e-6
    assert _rel(got.cpu(), dense.cpu()) <= 1e-5
    want = fk.framed_filterbank_plain(x.double(), wc.double(), ws.double(), fb.double(), 160)
    assert _rel(got.cpu(), want.cpu()) <= 2e-6
