"""The ``whisper128_16k`` configuration's reference against openai's
``log_mel_spectrogram`` in float64 NumPy, its control, its least-work counts
against hand-worked values, and its cell at tiny sizes."""
import json

import numpy as np
import pytest
import torch
from scipy.signal import get_window

from bench_port import run
from bench_port.reference import builders
from bench_port.reference import whisper128_16k as ref
from bench_port.tests import tiny
from bench_port.tests.tiny import BENCH
from bench_port.work import counts
from bench_port.work import whisper128_16k as work

WINDOW = 480_000  # 30 s at 16 kHz
FRAMES = 3001     # 1 + 480000 // 160, the last of which Whisper drops


def settings(name="whisper128_16k"):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["settings"]


def log_mel_numpy(x, s):
    """openai's log_mel_spectrogram in float64, floored per clip."""
    n, hop = s["n_fft"], s["hop_length"]
    padded = np.pad(x, ((0, 0), (n // 2, n // 2)), mode="reflect")
    t = (padded.shape[1] - n) // hop + 1
    frames = np.stack([padded[:, i * hop:i * hop + n] for i in range(t)], 1)
    power = np.abs(np.fft.rfft(frames * get_window("hann", n, fftbins=True), axis=-1)) ** 2
    filters = builders.mel_filterbank(s["sr"], n, s["n_mels"], s["fmin"], s["fmax"])
    mel = np.einsum("mf,btf->bmt", filters, power[:, :-1])
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def test_the_settings_are_whispers():
    s = settings()
    assert (s["sr"], s["n_fft"], s["hop_length"], s["n_mels"]) == (16000, 400, 160, 128)
    assert s["n_samples"] == s["sr"] * s["chunk_length"] == WINDOW
    assert s["n_frames"] == WINDOW // s["hop_length"] == FRAMES - 1
    assert (s["fmax"], s["amin"], s["log_floor"]) == (8000.0, 1e-10, 8.0)


def test_the_reference_is_openais_log_mel_in_float64():
    s = settings()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16000)) * np.array([[1.0], [0.01]])
    got = ref.offline(s, torch.tensor(x, dtype=torch.float32)).double().numpy()
    want = log_mel_numpy(x.astype(np.float32).astype(np.float64), s)
    assert got.shape == want.shape == (2, 128, 100)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_control_reads_far_from_the_reference():
    s = settings()
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 16000)), dtype=torch.float32)
    a, b = ref.offline(s, x).double(), ref.offline(s, x, control=True).double()
    err = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a))
    assert 1e-5 < err < 1e-2


def test_a_whisper_call_moves_110_6_mb():
    s = settings()
    assert counts.frames(WINDOW, 400, 160, True) == FRAMES
    assert work._mel_nonzeros(16000, 400, 128, 0.0, 8000.0, False, 1) == 394
    assert work.frame_flops(s) == pytest.approx(counts.rfft_flops(400) + 3 * 201 + 2 * 394)
    flops, nbytes = work.least("K2", "offline", (32, WINDOW), s)
    assert nbytes == 4 * 32 * (WINDOW + 128 * FRAMES) == 110_608_384
    assert flops == pytest.approx(32 * FRAMES * work.frame_flops(s))
    # bytes bound it: 33 us at 3.35 TB/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(110_608_384 / 3.35e12)
    flops, nbytes = work.least("call", "offline", (32, WINDOW), s)
    assert nbytes == 4 * 32 * (WINDOW + 128 * (FRAMES - 1))
    assert flops == pytest.approx(32 * FRAMES * work.frame_flops(s) + 6 * 32 * 128 * 3000)
    assert work.least("K3", "offline", (32, WINDOW), s) is None
    assert work.least("call", "stream", (32, WINDOW), s) is None


def test_the_cell_runs_correct_at_tiny_sizes(tmp_path, capsys):
    root, base = tiny.tree(tmp_path)
    rc = run.main(["--workload", "whisper128_16k.serve_b32x30s", "--seed", str((1 << 31) + 21),
                   "--seconds", "0.3"],
                  device="cpu", root=root, base=base)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0
    assert {"audio_s_per_s", "setup_s"} <= set(result["metrics"])
