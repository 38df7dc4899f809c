"""The ``istft1024_24k`` configuration's reference against float64 NumPy, its
control, and its least-work counts against hand-worked values."""
import json

import numpy as np
import pytest
import torch
from scipy.signal import get_window

from bench_port.reference import istft1024_24k as ref
from bench_port.tests.tiny import BENCH
from bench_port.work import counts
from bench_port.work import istft1024_24k as work

SMALL = {"sr": 8000, "n_fft": 64, "hop_length": 16, "win_length": 64, "window": "hann"}


def settings():
    return json.loads((BENCH / "configs" / "istft1024_24k.json").read_text())["settings"]


def istft_same_numpy(spec, n, hop):
    """Vocos's ISTFT(padding="same") in float64: (B, F, T) complex -> (B, T hop)."""
    w = get_window("hann", n, fftbins=True)
    frames = np.fft.irfft(spec, n, axis=1) * w[None, :, None]
    t = spec.shape[-1]
    size = (t - 1) * hop + n
    y, env = np.zeros((spec.shape[0], size)), np.zeros(size)
    for i in range(t):
        y[:, i * hop:i * hop + n] += frames[:, :, i]
        env[i * hop:i * hop + n] += w ** 2
    pad = (n - hop) // 2
    return y[:, pad:-pad] / env[pad:-pad]


def test_requests_are_the_uncentred_stft():
    x = np.random.default_rng(0).standard_normal((3, 64 + 16 * 20))
    got = ref.requests(SMALL, torch.tensor(x, dtype=torch.float32)).double().numpy()
    frames = np.stack([x[:, i * 16:i * 16 + 64] for i in range(21)], axis=2)
    want = np.fft.rfft(frames * get_window("hann", 64, fftbins=True)[None, :, None], axis=1)
    assert got.shape == (3, 33, 21, 2)
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], want, atol=2e-6 * np.abs(want).max())


def test_synthesis_is_vocos_same_and_inverts_the_requests():
    x = np.random.default_rng(1).standard_normal((2, 64 + 16 * 30))
    spec = ref.requests(SMALL, torch.tensor(x, dtype=torch.float32))
    got = ref.synthesis(SMALL, spec).double().numpy()
    s64 = spec.double().numpy()
    want = istft_same_numpy(s64[..., 0] + 1j * s64[..., 1], 64, 16)
    assert got.shape == want.shape == (2, 31 * 16)
    np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, x[:, 24:24 + 31 * 16], atol=1e-5 * np.abs(x).max())


def test_control_reads_far_from_the_reference():
    x = np.random.default_rng(2).standard_normal((2, 64 + 16 * 30))
    spec = ref.requests(SMALL, torch.tensor(x, dtype=torch.float32))
    a = ref.synthesis(SMALL, spec).double()
    b = ref.synthesis(SMALL, spec, control=True).double()
    err = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a))
    assert 5e-5 < err < 2e-3


def test_the_window_is_vocos_periodic_hann():
    s = settings()
    w = ref.window(s, "cpu")
    assert torch.allclose(w, torch.hann_window(s["win_length"]), atol=1e-7)
    assert ref.pad(s) == 384


def test_a_middle_step_moves_3_4_mb():
    s = settings()
    flops, nbytes = work.least("step", "synth", (128, 4, 1024, False, False), s)
    spectra = 4 * 2 * 128 * 513 * 4
    assert spectra == 2_101_248
    assert nbytes == spectra + 4 * 128 * (1024 + 2 * 768) == 3_411_968
    assert flops == 128 * 4 * (25_600 + 1024) + 128 * 1024
    assert counts.rfft_flops(1024) == 25_600
    # bytes bound it: about 1 us at 3.35 TB/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_first_and_last_steps_read_or_write_no_tail():
    s = settings()
    _, first = work.least("step", "synth", (128, 4, 640, True, False), s)
    _, last = work.least("step", "synth", (128, 4, 1024 + 384, False, True), s)
    assert first == 2_101_248 + 4 * 128 * (640 + 768)
    assert last == 2_101_248 + 4 * 128 * (1408 + 768)


def test_k3_reads_the_spectra_and_writes_its_block():
    s = settings()
    flops, nbytes = work.least("K3", "synth", (128, 4, 1024, False, False), s)
    assert nbytes == 2_101_248 + 4 * 128 * (1024 + 3 * 256) == 3_018_752
    assert flops == 128 * 4 * (25_600 + 1024)
    assert work.least("K3", "stream", (128, 4, 1024, False, False), s) is None
    assert work.least("K5", "synth", (128, 4, 1024, False, False), s) is None
