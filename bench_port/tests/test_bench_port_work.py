"""The least-work counts held to hand-worked values at the cells' shapes, and
the inversion's elementwise reader on a made-up trace."""
import json
import math

import numpy as np
import pytest

from bench_port.reference import builders
from bench_port.tests.tiny import BENCH
from bench_port.work import counts, cqt84_22k, mel80_22k, mel128_22k

CLIP = 220500  # 10 s at 22,050 Hz
FRAMES = 431  # 1 + 220500 // 512


def settings(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return {**cfg["settings"], **cfg.get("train", {})}


def test_frames_of_a_centred_clip():
    assert counts.frames(CLIP, 2048, 512, True) == FRAMES
    assert counts.frames(CLIP, 16384, 512, True) == FRAMES
    assert counts.frames(2048 + 1536, 2048, 512, False) == 4


def test_mel_serve_call_moves_35_3_mb():
    flops, nbytes = mel128_22k.least("call", "offline", (32, CLIP), settings("mel128_22k"))
    assert nbytes == 4 * 32 * (CLIP + 128 * FRAMES) == 35_285_504
    assert round(nbytes / 1e6, 1) == 35.3
    # bytes bound it: 10.5 us at 3.35 TB/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(35_285_504 / 3.35e12)
    assert K2_equals_call()


def K2_equals_call():
    s = settings("mel128_22k")
    return (mel128_22k.least("K2", "offline", (32, CLIP), s)
            == mel128_22k.least("call", "offline", (32, CLIP), s))


def test_mel_frame_counts_a_real_fft_and_the_filterbank_nonzeros():
    s = settings("mel128_22k")
    nz = np.count_nonzero(builders.mel_filterbank(22050, 2048, 128))
    assert nz <= 2 * 1025  # each FFT bin lies in at most two triangles
    flops, _ = mel128_22k.least("call", "offline", (1, 1536), s)  # 4 frames
    assert flops == 4 * (2.5 * 2048 * 11 + 3 * 1025 + 2 * nz)


def test_train_step_holds_242_5_gflop():
    b, t, f, n, m, c = 32, FRAMES, 1025, 2048, 128, 10
    pair = 2 * (2 * b * t * f * n)  # the cos and sin products
    want = 2 * pair + 3 * (2 * b * t * m * f) + 3 * (2 * b * m * c)
    flops, nbytes = mel128_22k.least("step", "train", (b, CLIP), settings("mel128_22k"))
    assert flops == want
    assert round(flops / 1e9, 1) == 242.5
    params = 2 * f * n + m * f + m * c + c
    assert nbytes == 4 * (b * CLIP + 2 * params)
    # operations bound it: about 0.49 ms at 495 TFLOP/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(flops / 495e12)
    k5, _ = mel128_22k.least("K5", "train", (b, CLIP), settings("mel128_22k"))
    dw, _ = mel128_22k.least("dw_gemm", "train", (b, CLIP), settings("mel128_22k"))
    assert k5 == dw == pair == pytest.approx(115.8e9, rel=1e-3)


def test_stream_step_counts_the_chunk_the_carry_and_the_frames():
    s = settings("mel128_22k")
    flops, nbytes = mel128_22k.least("step", "stream", (32, 2048, 1536), s)
    assert nbytes == 4 * 32 * (1536 + 2048 + 128 * 4 + 1536)
    k2_flops, k2_bytes = mel128_22k.least("K2", "stream", (32, 2048, 1536), s)
    assert k2_flops == flops and k2_bytes == 4 * 32 * (1536 + 2048 + 128 * 4)
    # the first step of a stream completes one frame and carries 1536
    first, _ = mel128_22k.least("step", "stream", (32, 2048, 0), s)
    assert first == flops / 4


def test_parts_outside_a_loop_read_nothing():
    s = settings("mel128_22k")
    assert mel128_22k.least("K5", "offline", (32, CLIP), s) is None
    assert mel128_22k.least("K6", "offline", (32, CLIP), s) is None
    assert cqt84_22k.least("K2", "offline", (32, CLIP), settings("cqt84_22k")) is None


def test_cqt_takes_the_lesser_route():
    s = settings("cqt84_22k")
    per_frame, banded, spectral, width = cqt84_22k.frame_flops(
        s["sr"], s["fmin"], s["n_bins"], s["bins_per_octave"], s["filter_scale"],
        s["norm"], s["window"])
    assert width == 16384
    kernels, lengths = builders.cqt_bank(22050, 32.70, 84, 12)
    # a periodic Hann window of l samples has one zero; cos and sin parts
    assert banded == pytest.approx(2 * 2 * (lengths - 1).sum(), rel=1e-3)
    assert spectral > 2.5 * width * 14
    assert per_frame == min(banded, spectral) + 4 * 84
    flops, nbytes = cqt84_22k.least("call", "offline", (32, CLIP), s)
    assert flops == 32 * FRAMES * per_frame
    assert nbytes == 4 * 32 * (CLIP + 84 * FRAMES)
    # operations bound it: about 20 us
    assert counts.least_seconds(flops, nbytes) == pytest.approx(flops / 495e12)
    assert 15e-6 < flops / 495e12 < 25e-6


def test_sparse_spectral_kernel_drops_the_small_tail():
    row = np.zeros((1, 16), dtype=complex)
    row[0, 3] = 1.0  # one tone: its FFT has 16 unit entries over the full circle
    assert counts.sparse_spectral_nonzeros(row) == 9  # every entry of the one-sided half
    kernels, _ = builders.cqt_bank(22050, 32.70, 84, 12)
    nz = counts.sparse_spectral_nonzeros(kernels)
    assert 0 < nz < 84 * (16384 // 2 + 1) / 10


def test_peaks_are_the_data_sheet_rates():
    assert counts.PEAK_FLOPS == 495e12 and counts.PEAK_BYTES == 3.35e12
    assert counts.rfft_flops(2048) == 2.5 * 2048 * math.log2(2048)


#: one inversion call: 32 mels of 862 frames (10 s at hop 256), 32 Griffin-Lim
#: iterations, 64 NNLS steps
INVERT = (32, 862, 32, 64)


def test_invert_call_reads_the_mel_and_phase_and_writes_the_audio():
    s = settings("mel80_22k")
    assert counts.frames(CLIP, 1024, 256, True) == 862
    flops, nbytes = mel80_22k.least("call", "invert", INVERT, s)
    mel, phase, audio = 4 * 32 * 80 * 862, 4 * 32 * 513 * 862, 4 * 32 * 861 * 256
    assert (round(mel / 1e6, 1), round(phase / 1e6, 1), round(audio / 1e6, 1)) == (8.8, 56.6, 28.2)
    assert nbytes == mel + phase + audio
    nz = np.count_nonzero(builders.mel_filterbank(22050, 1024, 80, 0.0, 8000.0))
    cols = 32 * 862
    ffts = 65 * cols * 2.5 * 1024 * 10  # 32 analyses, 33 syntheses
    nnls = cols * (2 * 513 * 80 + 64 * 2 * 2 * nz)
    assert flops == ffts + 12 * 32 * 513 * cols + nnls
    # operations bound it: about 0.12 ms at 495 TFLOP/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(flops / 495e12)
    assert 0.1e-3 < flops / 495e12 < 0.13e-3


def test_invert_kernels_count_each_launch_of_a_call():
    s = settings("mel80_22k")
    cols = 32 * 862
    spectra = 4 * 2 * 32 * 513 * 862
    k3_flops, k3_bytes = mel80_22k.least("K3", "invert", INVERT, s)
    assert k3_bytes == 33 * (spectra + 4 * 32 * (1024 + 256 * 861))
    assert k3_flops == 33 * cols * (2.5 * 1024 * 10 + 1024)
    # bytes bound a launch: about 42 us
    assert k3_bytes / 33 / 3.35e12 == pytest.approx(42.2e-6, rel=1e-2)
    k5_flops, k5_bytes = mel80_22k.least("K5", "invert", INVERT, s)
    assert k5_bytes == 32 * (4 * 32 * (256 * 861 + 1024) + spectra)
    assert k5_flops == 32 * cols * 2.5 * 1024 * 10
    assert k5_bytes / 32 / 3.35e12 == pytest.approx(42.2e-6, rel=1e-2)


def test_nnls_products_count_their_operands_and_the_basis_nonzeros():
    s = settings("mel80_22k")
    nz = np.count_nonzero(builders.mel_filterbank(22050, 1024, 80, 0.0, 8000.0))
    assert nz <= 2 * 513
    cols = 32 * 862
    flops, nbytes = mel80_22k.least("nnls_gemm", "invert", INVERT, s)
    assert flops == 2 * 513 * 80 * cols + 64 * 4 * nz * cols
    seed = 4 * (513 * 80 + 80 * cols + 513 * cols)
    assert nbytes == seed + 64 * 2 * 4 * (80 * 513 + 513 * cols + 80 * cols)
    assert mel80_22k.least("call", "offline", (32, CLIP), s) is None
    assert mel128_22k.least("call", "invert", INVERT, settings("mel128_22k")) is None


def test_the_elementwise_reader_leaves_out_copy_kernels():
    from types import SimpleNamespace as NS

    from bench_port import harness, trace

    t = trace.Trace(window_s=1.0, busy_s=0.5,
                    kernel_s={"vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>": 0.03,
                              "elementwise_kernel<128, 2, gpu_kernel_impl_nocast<"
                              "direct_copy_kernel_cuda>>": 0.02,
                              "synthesis_tc_kernel<float, 128, false>": 0.1},
                    launches=[], idle_by_host=[], stats={"attempted": 3}, host_stats={})
    read = harness.reader("elementwise_ms_per_call.invert")
    assert read(NS(trace=t)) == pytest.approx(10.0)
    assert read(NS(trace=None)) is None
