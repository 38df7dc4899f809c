#!/usr/bin/env python3
"""Drive the PyTorch port (nnaudio_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each draws its random inputs from a generator of its own, seeded
from a fixed constant):
 1. the device, and ``nvidia-smi``'s name and power limit;
 2. build every CUDA kernel from ``nnaudio_tpu_torch/csrc`` (nvcc, sm_90a);
 3. hold each kernel against its plain PyTorch version on the card, in fp32
    and bf16 storage, at the slice shapes, at hops 160 and 441, at bin counts
    that are no multiple of a tile, and at 64, 128 and 256 mels; the
    Griffin-Lim step (K4) also in fp32 and bf16 carries, and the pair (K5)
    with its backward against plain autograd; the tensor-core kernels (K1,
    K2, K4, K5) also at one bin and one mel, at 300 mels, at fewer frames
    than a tile, at the pyramid's and the CQT's banks, at a bank length no K
    chunk divides and at an odd signal length, twice for bit equality, and
    their 3xTF32 arithmetic against fp64 beside the plain fp32 version's (K5
    the product, K2 the filterbank of the power, K4 its four carries); the
    banded split-K magnitude (K6) against the plain version and against K1
    at the CQT shape (84 wavelets of 16384 samples, B=32 and B=1), on that
    bank with one entry set far outside an atom and with its middle group
    zero, on CQT1992's dense composed bank and at odd shapes, twice for bit
    equality, in fp32 against fp64 beside the plain fp32 version, and its
    pre-pass's group ranges against the plain ones (``[bank]`` lines); the
    synthesis (K3, on the tensor cores) at (b)'s, (e)'s and (h)'s inverse
    shapes, at the collapsed pyramid dual banks of (n) (48 bins, hop 128)
    and of CQT2010v2() at its defaults (84 x 32386, hop 512), and hops 160,
    441 and 3, twice for bit equality, and in fp32 storage against fp64
    beside the plain fp32 version's error, with both of its fp32 sums
    launched (the compensated one where a row's sum is longer than 512
    steps: hop 3; the plain one up to it: the others); K1/K2/K4/K5 also at
    the chroma
    shape (12 rows x 1025 bins). K2 has two routes: a frozen Fourier basis
    (the slice shapes' bases) in fp32 storage takes its FFT route
    (``csrc/framed_fft.cu``, counted as ``framed_filterbank_fft``), every
    other basis and bf16 storage dense K2; each case also holds dense K2
    itself against the plain version. K3 has two routes as well: an iSTFT's
    frozen Fourier factors in fp32 storage take its FFT route (the same
    source, counted as ``synthesis_ola_fft``), held against its plain mirror,
    the dense plain version and fp64 at the Griffin-Lim cell's, the
    synthesis stream's and (b)'s shapes, an odd hop, and the halves of a
    (B, F, T, 2) stack, twice for bit equality. K4 has three: a frozen
    Fourier basis with fp32 carries in fp32 storage takes its FFT route (the
    same source, counted as ``gl_step_fft``), held against its plain mirror
    and against the pair (K5) and the update at the Griffin-Lim cell's step
    and at odd hops and widths, twice for bit equality; bf16 carries take
    the tensor-core K4 (the checks above launch it directly, in both carry
    types); every other step the pair and the update;
 4. the slice through the public entry points, with the launch counts set
    to 0 before each path and read after it:
    (a) the flagship SpectrogramClassifier answering 4 requests of
        32 x 10 s at 16 kHz, (b) STFT Magnitude 2048/512 at 32 x 10 s at
        22.05 kHz, (c) MelSpectrogram 128 at (b)'s size, (d) the iSTFT (and
        STFT.inverse) round trip of (b)'s Complex output; (a)-(c) in
        ``highest`` and in ``fast_mode()``; on a seeded batch of 32 x 10 s
        harmonic clips at 22.05 kHz, (e) mel -> audio: MelSpectrogram 80
        (1024/256) then InverseMelSpectrogram (64 NNLS + 32 Griffin-Lim
        iterations, bf16 carries), and (f) Griffin_Lim 2048/512 with fp32
        iterations on (b)'s magnitude (K4's FFT route); (g) CQT1992v2 at its defaults (84 bins
        of 16384 samples, hop 512) on 32 x 10 s and on one 10 s clip,
        Magnitude, in both modes; (h) its Complex output, and Complex ->
        ``.inverse`` at sr 22050 / fmin 55 / 48 bins / hop 128 on seeded
        in-band tones (interior SNR > 40 dB); (i) CQT2010v2 and VQT at their
        defaults (one pair launch per octave; VQT(gamma=0) equal to
        CQT2010v2). Each output is checked finite, of its shape, against the
        plain path on the card (Griffin-Lim at 2 iterations; at 32 by
        spectral convergence), and the STFT and the CQT against numpy on a
        small input. Then training, one SGD step at 32 x 10 s in both
        modes: (j) the classifier's ``train_step`` at the entry config and
        at bench's 2048/512/128-mel, (k) the trainable STFT and (l) the
        trainable CQT1992v2 under bench's losses, each with exact launches
        (the pair, K5, once; no K1, K2, K6 or K3) and its loss and gradients
        against the plain route (the trainable STFT's fp32 gradients against
        the plain route in fp64, within max(1e-4, 4x the fp32 plain route's
        own error)); the input's gradient through a frozen STFT at (b)'s
        shape (K3 as dx) and a trainable iSTFT's step at (d)'s shape (K3
        forward). Then (m) Gammatonegram() and ChromaSTFT() at
        their defaults in both modes (K2 x1 each) and one SGD step of each
        with a trainable bank and STFT (K5 x1); (n) the pyramid ``.inverse``
        of CQT2010v2, VQT(gamma=5) and CQT2010 at sr 22050 / fmin 55 / 48
        bins / hop 128 on seeded in-band tones (K5 per octave, K3 x1, SNR >
        40 dB), CQT2010v2 with early downsampling at hop 64 (> 35 dB) and
        CQT2010v2() at its defaults (K3 at the 84 x 32386 bank, SNR not
        held); (o) GriffinLimCQT in the families 1992v2, 2010v2 and vqt, 32
        iterations (K5 x32, or x32 per octave, K3 x33; spectral convergence
        < 0.2 and within 0.05 of the plain path's); (p) the parallel chain
        and the fused pyramid, each alone, at (i)'s CQT2010v2() and
        VQT(gamma=2) against the serial loop, timed beside it (``[ab]``
        lines); (q) CFP(fs=16000) and Combined_Frequency_Periodicity() on
        32 x 10 s at 16 kHz (no kernel; a numpy fp64 oracle on one clip,
        use_mxu_fft against the default path); (r) TimeStretch(1024, 256)
        at rates 0.8 and 1.25 and PitchShift(n_steps=7) (K5 x1, K3 x1, each
        kernel stage against its plain version on the path's inputs, the
        output's STFT magnitude against the plain path's by spectral
        convergence < 1e-3, and on one clip the vocoder in fp64 and fp32 on
        both paths' STFTs) on the harmonic batch, and resample 22050 ->
        16000 against scipy; (s) streaming at full width, 32 streams x 10 s
    at 22.05 kHz in 2048-sample chunks, in both modes: StreamingSTFT
    Magnitude (K1) and Complex (K5), StreamingMel 128 at power 2 (K2) and 1
    (K1), StreamingMFCC, StreamingGammatone and StreamingChroma (K2),
    StreamingCQT() Magnitude (K6) and Complex (K5), StreamingiSTFT on
    StreamingSTFT's Complex frames and StreamingInverseCQT at (h)'s config
    on StreamingCQT's (K3), each against its offline center=False
    transform, one launch per primed step and none while priming, the same
    frames with fuse=False and no launch, ms per step at B=32 and B=1,
    audio-s/s and the idle share of 20 steps; then each kernel at a step's
    shapes (T=4 and T=1) against its plain version and timed; (t) parallel
    at world size 1 (an NCCL group of one, a (1, 1) mesh): data_parallel,
    bank_sharded_apply, contraction_sharded_cqt1992, bank_sharded_inverse,
    time_sharded_stft / istft against the single-device calls with the same
    launches; (u) utils: a trained MelSpectrogram's state saved and
    restored in .npz and torch.save formats bit for bit, and
    profiling.trace around one (b) call naming K1's kernel;
 5. CUDA-event times (median of 15 after warm-up, the host queued ahead of
    the device so that a short kernel's time is the device's) of each kernel,
    its plain version and one PyTorch library call computing the same
    function, K1 and K5 also on one clip (for
    K4 a composite: ``torch.stft`` and the elementwise update; for K6 two
    strided ``F.conv1d`` and ``torch.hypot``; its bound counts the products
    against the bank's nonzero entries), K1 at K6's shapes, and K6 over a
    range of split counts, K2 also at (c)'s shape, K3 also at (e)'s and at
    (n)'s default dual bank; the K1 / K6 dispatch swept over B = 1-32 on the
    CQT banks and dense banks of 64-128 bins x 2048-16384 samples
    (``[sweep]`` lines, with what the dispatch rule loses where it picks the
    slower kernel); paths (a)-(c), (e)-(i), (o), (q) and the train steps
    also print one call's device time by kernel under ``torch.profiler``,
    which fails if it misses a kernel the call launched;
 6. a ``kernels`` JSON line, the card's name and power limit, and the
    result line ``{"ok": true, "device": {...}}`` last.

Any failure raises and exits nonzero. Without CUDA it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

PEAK_TF32 = 495e12   # H100 SXM dense TF32, FLOP/s: the bound of fp32 storage
PEAK_BF16 = 989e12   # H100 SXM dense bf16, FLOP/s
HBM_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
TOL = {"highest": 1e-4, "default": 5e-2}  # tests/test_ops.py:213-216
# K4's bf16 carries: kernel and plain version round fp32 values that differ
# in the last bits, so an element may land one bf16 step apart; the JAX
# suite holds the bf16 Griffin-Lim step at 2e-2 (tests/test_ops.py:596)
CARRY_TOL = {torch.float32: 0.0, torch.bfloat16: 2e-2}
# |c| against S, elementwise over max S: fp32 rounding, or one bf16 rounding
# of each component (relative 2^-9 each)
MAG_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Griffin-Lim loop against Griffin-Lim loop (tests/test_ops.py:731,782), and
# its spectral convergence (tests/test_ops.py:647-648)
GL_TOL = {"highest": 5e-4, "default": 3e-2}
SC_DELTA, SC_CEILING = 0.05, 0.25
MOM = 0.99 / 1.99  # Griffin_Lim's momentum 0.99 as the loop applies it
REPS = 15
# each phase draws its random inputs from a generator of its own, seeded from
# a fixed constant, so that adding or removing a phase, or a draw inside one,
# changes no other phase's inputs
PHASE_SEEDS = {"3 kernels": 301, "3 tensor cores": 302, "3 K6": 303, "3 K3": 304, "3 K4": 305,
               "3 NNLS": 306, "e NNLS": 418,
               "a highest": 401, "a default": 402, "b highest": 403, "b default": 404,
               "d": 405, "g": 406, "j-l": 407, "b grad, d step": 408, "m": 409,
               "o": 410, "p": 411, "q": 412, "s": 413, "t": 414, "u": 415,
               "w highest": 416, "w default": 417,
               "5 highest": 501, "5 default": 502, "sweep": 503}
# the pyramid inverses' config (tests/test_inverse_cqt.py:176-236): hop 128 is
# at most half the shortest atom, where the inverse is good
INV_CFG = dict(sr=22050, fmin=55, n_bins=48, bins_per_octave=12, hop_length=128,
               earlydownsample=False)
# the pyramid switches against the serial loop (tests/test_cqt.py:156,
# tests/test_pyramid_fused.py:84), of max |ref|
SWITCH_TOL = 2e-5
# GriffinLimCQT's spectral convergence (tests/test_inverse_cqt.py:274)
SC_CQT_CEILING = 0.2
# the device kernel each launch counter stands for, as the profiler names it
PROFILE_NAMES = {"framed_magnitude": "framed_tc_kernel",
                 "framed_filterbank": "framed_tc_kernel",
                 "synthesis_ola": "synthesis_tc_kernel", "gl_step": "framed_tc_kernel",
                 "framed_pair": "framed_tc_kernel",
                 "framed_magnitude_kchunk": "kchunk_tc_kernel",
                 "framed_filterbank_fft": "framed_fft_filterbank_kernel",
                 "synthesis_ola_fft": "synthesis_fft_ola_kernel",
                 "gl_step_fft": "gl_step_fft_kernel",
                 "nnls_banded": "nnls_banded_kernel"}


def k2_route(mode):
    """The launch counter of K2 for a frozen Fourier basis in a precision
    mode: its FFT route in fp32 storage, dense K2 in bf16 storage."""
    return "framed_filterbank" if mode == "default" else "framed_filterbank_fft"


def k3_route(mode):
    """The launch counter of K3 for an iSTFT's frozen Fourier factors in a
    precision mode: its FFT route in fp32 storage, dense K3 in bf16."""
    return "synthesis_ola" if mode == "default" else "synthesis_ola_fft"


def fft_frame_flops(n, nnz):
    """The least operations of one frame of a frozen Fourier basis and a
    filterbank (as ``bench_port/work`` counts them): a real FFT, 2.5 N log2 N,
    3 a bin for the power, 2 for each nonzero entry of the filterbank."""
    return 2.5 * n * np.log2(n) + 3 * (n // 2 + 1) + 2 * nnz



def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def spill_report(lib_path, nvcc) -> dict | None:
    """Local-memory instructions (LDL, STL: spills) of each kernel of a built
    library, by the warpgroup role that runs them, read from its SASS:
    {kernel: {role: count}}. The role is set by the last `setmaxnreg` before
    the instruction: the increase starts the multiplying warpgroups' code,
    the decrease the loading ones'. None where the toolkit has no
    cuobjdump."""
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, func, role = {}, None, "entry"
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func, role = found.group(1), "entry"
            counts[func] = {"entry": 0, "multiplying": 0, "loading": 0}
        elif "USETMAXREG" in line:
            role = "multiplying" if "TRY_ALLOC" in line else "loading"
        elif func and re.search(r"\b(LDL|STL)\b", line):
            counts[func][role] += 1
    return counts


def kernel_label(mangled: str) -> str:
    """framed_tc_kernel<float, 112> from its mangled name."""
    found = re.search(r"([a-z_]+_kernel)I(.*?)EEv", mangled)
    if not found:
        plain = re.search(r"([a-z_]+_kernel)E", mangled)
        return plain.group(1) if plain else mangled[:60]
    args = [{"13__nv_bfloat16": "bf16", "f": "float"}.get(t, n or ("true" if b == "1" else "false"))
            for t, n, b in re.findall(r"(13__nv_bfloat16|f|Li(\d+)E|Lb([01])E)", found.group(2))]
    return f"{found.group(1)}<{', '.join(args)}>"


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def cuda_ms(fn, reps=REPS, warmup=3, queue_ahead=False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls.
    With ``queue_ahead`` the device first spins for about a millisecond, so
    the host has queued the whole call before the first event fires and the
    time is the device's alone, also for a call shorter than its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def gl_step_errors(fk, got, x, wc, ws, S, p_re, p_im, hop, mom):
    """K4's outputs against its plain version: (r error, c error on the
    elements where |n| >= 1e-2 rms|n|, max ||c| - S| / max S, elements
    excluded, max abs error). r and |c| are held against the plain version
    as it runs (fp32 products); c against the plain version evaluated in fp64
    on the same storage-rounded operands and rounded to the carry type:
    c = S n/|n| magnifies the pair's rounding where |n| is small, and the
    fp32 plain version's own c is ~1e-4 of max |c| off the fp64 one (at (b)),
    as far as the kernel's tolerance. Where |n| -> 0 the direction of c
    turns with the last bits of the sum, so those elements are held only by
    |c|."""
    from nnaudio_tpu_torch.config import round_to_storage

    plain = [o.float() for o in fk.gl_step_plain(x, wc, ws, S, p_re, p_im, hop, mom)]
    frames = round_to_storage(x).double().unfold(-1, wc.shape[-1], hop)
    re = torch.einsum("fn,btn->bft", round_to_storage(wc).double(), frames)
    im = torch.einsum("fn,btn->bft", round_to_storage(ws).double(), frames)
    exact = [o.float() for o in fk.gl_update(re, im, S, p_re, p_im, mom)]
    n_abs = torch.hypot(re - mom * p_re.double(), -im - mom * p_im.double())
    keep = n_abs >= 1e-2 * n_abs.square().mean().sqrt()
    del frames, re, im, n_abs
    got = [o.float() for o in got]
    r_err = max(rel_err(got[k], plain[k]) for k in (2, 3))
    c_err = max(float(((got[k] - exact[k]).abs() * keep).max() / exact[k].abs().max())
                for k in (0, 1))
    mag_err = float((torch.hypot(got[0], got[1]) - S).abs().max() / S.max())
    abs_err = max(float(((got[k] - plain[k]).abs() * (keep if k < 2 else 1)).max())
                  for k in range(4))
    return r_err, c_err, mag_err, int((~keep).sum()), abs_err


def fp64_errors(fk, x, wc, ws, fb, S, p_re, p_im, hop, mom):
    """K2 and K4 in fp32 storage (K4 with fp32 carries p_re, p_im) and their
    plain fp32 versions against the same functions in fp64: {"K2": (kernel,
    plain), "K4": (kernel, plain)}, each the max error over max |ref|, K4's
    the largest of its four outputs, c where the fp64 |n| >= 1e-2 rms|n|."""
    frames = x.double().unfold(-1, wc.shape[-1], hop)
    re = torch.einsum("fn,btn->bft", wc.double(), frames)
    im = torch.einsum("fn,btn->bft", ws.double(), frames)
    ref2 = torch.einsum("mf,bft->bmt", fb.double(), re * re + im * im + 1e-8)
    ref4 = fk.gl_update(re, im, S.double(), p_re.double(), p_im.double(), mom)
    n_abs = torch.hypot(re - mom * p_re.double(), -im - mom * p_im.double())
    keep = n_abs >= 1e-2 * n_abs.square().mean().sqrt()

    def err(got, ref, mask=None):
        d = (got.double() - ref).abs()
        return float((d if mask is None else d * mask).max() / ref.abs().max())

    def err4(got):
        return max(err(g, r, keep if k < 2 else None)
                   for k, (g, r) in enumerate(zip(got, ref4)))
    return {"K2": (err(fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8), ref2),
                   err(fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8), ref2)),
            "K4": (err4(fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, mom)),
                   err4(fk.gl_step_plain(x, wc, ws, S, p_re, p_im, hop, mom)))}


def synthesis_fp64(sre, sim, kc, ks, hop):
    """K3's function evaluated in fp64: frames then overlap-add."""
    from nnaudio_tpu_torch.core.frame import frames_to_signal

    frames = (torch.einsum("fj,bft->btj", kc.double(), sre.double())
              - torch.einsum("fj,bft->btj", ks.double(), sim.double()))
    return frames_to_signal(frames, hop, kc.shape[1] + hop * (sre.shape[-1] - 1))


def grads_of(loss_fn, leaves):
    """(loss, [d loss / d leaf]) on fresh leaves, the inputs left as they are."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = loss_fn(*leaves)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def pair_grads(fn, x, wc, ws, hop, g_re, g_im):
    """Outputs and gradients of a pair function under one random cotangent."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, wc, ws)]
    re, im = fn(*leaves, hop)
    (re * g_re + im * g_im).sum().backward()
    return [re.detach(), im.detach()] + [t.grad for t in leaves]


def profile_path(fn):
    """Device time by kernel over one call under ``torch.profiler``: (wall ms
    of the call under the profiler, {kernel name: (ms, launches)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # let the tracer start before the call: a kernel launched in the
        # first moments of the trace can be missing from it
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return wall * 1e3, kernels


def harmonic_batch(batch, n, sr, seed, device):
    """Seeded clips of a tone with three overtones plus a linear sweep, so
    Griffin-Lim has phase structure to recover (on white noise it has none)."""
    rng = np.random.RandomState(seed)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    clips = []
    for _ in range(batch):
        f0 = rng.uniform(110, 440)
        x = sum(torch.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
                for k in range(1, 5))
        fa, fb = rng.uniform(200, sr / 4, 2)
        sweep = fa * t + (fb - fa) * t * t / (2 * float(t[-1]))
        clips.append(x + 0.5 * torch.sin(2 * np.pi * sweep))
    return (torch.stack(clips) / 2).float()


def inband_tones(batch, n, sr, seed, device, lo=110.0, hi=660.0):
    """Seeded clips of five tones between ``lo`` and ``hi`` Hz: material a
    CQT whose band covers them can be inverted from."""
    rng = np.random.RandomState(seed)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    clips = [sum(torch.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                 for f in rng.uniform(lo, hi, 5)) for _ in range(batch)]
    return torch.stack(clips).float()


def interior_snr_db(x, rec, margin=4096) -> float:
    """SNR of ``rec`` against ``x`` in dB, away from the clip edges."""
    core = slice(margin, x.shape[-1] - margin)
    err = rec[:, core] - x[:, core]
    return float(10 * torch.log10(x[:, core].square().sum() / err.square().sum()))


def cfp_oracle(x, filters, fr=2, fs=16000, hop=320, window_size=2049, fc=80,
               tc=1 / 1000, g=(0.24, 0.6, 1), num_per_oct=48):
    """CFP's Z in numpy fp64, by nnAudio's full-length recursion
    (tests/test_cfp.py:19-66): the full DFT of the windowed frames, the
    alternating relu^g / real-DFT layers with index cutoffs, and the
    triangular log-frequency projections of ``filters.cfp_logfreq_matrices``."""
    from scipy.signal.windows import blackmanharris

    n = int(fs / fr)
    h = blackmanharris(window_size)
    hp = np.zeros(n)
    hp[(n - window_size) // 2:(n - window_size) // 2 + window_size] = h
    xp = np.pad(x.astype(np.float64), n // 2)
    frames = np.stack([xp[t * hop:t * hop + n] for t in range((len(xp) - n) // hop + 1)])
    tfr0 = np.abs(np.fft.fft(frames * hp, axis=1)) / np.linalg.norm(h)
    tc_idx, fc_idx = round(fs * tc), round(fc / fr)

    def nl(v, gg, cutoff):
        v = np.maximum(v, 0.0)
        v[:, :cutoff] = 0
        if cutoff > 0:
            v[:, -cutoff:] = 0
        return v ** gg
    spec = np.maximum(tfr0, 0.0) ** g[0]
    ceps = nl(np.fft.fft(spec, axis=1).real / np.sqrt(n), g[1], tc_idx)
    spec = nl(np.fft.fft(ceps, axis=1).real / np.sqrt(n), g[2], fc_idx)
    high_f, high_q = int(round((1 / tc) / fr) + 1), int(round(fs / fc) + 1)
    f = fs * np.linspace(0, 0.5, n // 2, endpoint=True)[:high_f]
    q = np.arange(high_q) / float(fs)
    fm, qm = filters.cfp_logfreq_matrices(f, q, fr, fc, tc, num_per_oct, fs)
    return (fm @ spec[:, :n // 2][:, :high_f].T) * (qm @ ceps[:, :n // 2][:, :high_q].T)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from nnaudio_tpu_torch import config
    from nnaudio_tpu_torch import filters
    from nnaudio_tpu_torch.features import (CFP, CQT1992, CQT1992v2, CQT2010, CQT2010v2,
                                            ChromaSTFT, Combined_Frequency_Periodicity,
                                            Gammatonegram, Griffin_Lim, GriffinLimCQT,
                                            InverseMelSpectrogram, MelSpectrogram,
                                            PitchShift, STFT, TimeStretch, VQT,
                                            WhisperLogMel, iSTFT, phase_vocoder, resample)
    from nnaudio_tpu_torch.models import SpectrogramClassifier
    from nnaudio_tpu_torch.ops import build, dispatch as td, framed_kernels as fk

    def dense_k2(x, wc, ws, fb, hop, eps=0.0):
        """Dense K2 (``framed_tc`` FILTERBANK) whatever the basis, inside the
        wrapper's span, as ``framed_filterbank`` launches it for every basis
        that its FFT route does not take."""
        with fk.span("nnaudio.wrap.K2"):
            return fk._launch_filterbank(x, wc, ws, fb, hop, eps)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = smi()

    # ---------------------------------------------------------- 1. device --
    log(f"[device] {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    # ----------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.build_info['compiled'])} sources compiled in "
        f"{build.build_info['seconds']:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    # ptxas -v per kernel: registers, and the spill of its stack frame
    for src, report in build.build_info["ptxas"].items():
        for line in report.splitlines():
            if "Compiling entry function" in line:
                log(f"[build] {src}: {kernel_label(line.split(chr(39))[1])}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {src}:   {line.strip()}")
    # where the tensor-core kernels' spills run: the multiplying warpgroups
    # hold the accumulators, the loading ones only addresses
    for lib_name, kernel in (("framed_tc", "framed_tc_kernel"),
                             ("synthesis_ola", "synthesis_tc_kernel"),
                             ("framed_kchunk", "kchunk_tc_kernel")):
        spills = spill_report(build.library(lib_name)._name, build._nvcc())
        for func, by_role in (spills or {}).items():
            if kernel in func:
                log(f"[build] {lib_name}.cu {kernel_label(func)}: spill instructions "
                    f"(LDL/STL) in the multiplying warpgroups {by_role['multiplying']}, "
                    f"in the loading ones {by_role['loading']}, before either "
                    f"{by_role['entry']}")
        if spills is None:
            log("[build] no cuobjdump beside nvcc: spill sites not read")

    def phase_gen(key):
        return torch.Generator(device=dev).manual_seed(PHASE_SEEDS[key])

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def fourier(n_fft):
        st = STFT(n_fft=n_fft, hop_length=n_fft // 4, verbose=False, device=dev)
        return st.wcos, st.wsin

    # ---------------------------------------- 3. kernels vs plain versions --
    # (B, L, n_fft, hop, F, M): the slice shapes first, then odd hops, bin
    # counts that are no multiple of a tile, 64 / 128 / 256 mels, and for K2
    # and K4 one bin and one mel, fewer frames than a tile, and 300 mels;
    # last Whisper's n_fft 400 on a Fourier basis, K2's mixed-radix route
    cases = [
        ("slice (b)", 32, 220500 + 2048, 2048, 512, None, 128),
        ("slice (a)", 32, 160000 + 1024, 1024, 256, None, 64),
        ("hop 160", 4, 48000, 512, 160, None, 128),
        ("hop 441", 4, 66150, 2048, 441, None, 256),
        ("F 1000, hop 100", 2, 30000, 2048, 100, 1000, 64),
        ("F 201, hop 3", 2, 4000, 400, 3, 201, 256),
        ("F 1, M 1", 2, 30000, 2048, 512, 1, 1),
        ("T 3, M 40", 2, 2048 + 2 * 512, 2048, 512, None, 40),
        ("M 300, hop 3", 2, 4000, 400, 3, 201, 300),
        ("n_fft 400, hop 160", 4, 48000, 400, 160, None, 128),
    ]
    # fp32 storage (and carries), at the slice shapes
    max_abs = {k: 0.0 for k in fk.LAUNCHES}
    gen = phase_gen("3 kernels")
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, b, length, n_fft, hop, f, m in cases:
            wc, ws = fourier(n_fft)
            if f is not None:
                wc, ws = randn(f, n_fft), randn(f, n_fft)
            fb = torch.rand(m, wc.shape[0], generator=gen, device=dev)
            x = randn(b, length)
            k1 = fk.framed_magnitude(x, wc, ws, hop, eps=1e-8)
            torch.cuda.synchronize()
            p1 = fk.framed_magnitude_plain(x, wc, ws, hop, eps=1e-8)
            k1p = fk.framed_magnitude(x, wc, ws, hop, square=True)
            torch.cuda.synchronize()
            p1p = fk.framed_magnitude_plain(x, wc, ws, hop, square=True)
            fk.mark_own(fb)  # as a Mel's own, so that a Fourier basis takes K2's FFT route
            k2 = fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8)
            k2d = dense_k2(x, wc, ws, fb, hop, eps=1e-8)
            k2_key = ("framed_filterbank_fft" if fk.fft_plan(wc, ws, fb) is not None
                      else "framed_filterbank")
            torch.cuda.synchronize()
            p2 = fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8)
            t = k1.shape[-1]
            sre, sim = randn(b, wc.shape[0], t), randn(b, wc.shape[0], t)
            kc, ks = wc / n_fft, ws / n_fft
            k3 = fk.synthesis_ola(sre, sim, kc, ks, hop)
            torch.cuda.synchronize()
            p3 = fk.synthesis_ola_plain(sre, sim, kc, ks, hop)
            # K5 and its backward (dx through K3) against plain autograd
            g_re, g_im = randn(b, wc.shape[0], t), randn(b, wc.shape[0], t)
            k5 = pair_grads(fk.framed_pair, x, wc, ws, hop, g_re, g_im)
            torch.cuda.synchronize()
            p5 = pair_grads(fk.framed_pair_plain, x, wc, ws, hop, g_re, g_im)
            errs = {"K1": rel_err(k1, p1), "K1 power": rel_err(k1p, p1p),
                    "K2": rel_err(k2, p2), "K2 dense": rel_err(k2d, p2), "K3": rel_err(k3, p3),
                    "K5": max(rel_err(k5[i], p5[i]) for i in (0, 1)),
                    "K5 grads": max(rel_err(k5[i], p5[i]) for i in (2, 3, 4))}
            slice_fp32 = mode == "highest" and label.startswith("slice")
            if slice_fp32:
                for k, got, ref in (("framed_magnitude", k1, p1),
                                    ("framed_magnitude", k1p, p1p),
                                    (k2_key, k2, p2), ("framed_filterbank", k2d, p2),
                                    ("synthesis_ola", k3, p3),
                                    ("framed_pair", k5[0], p5[0]),
                                    ("framed_pair", k5[1], p5[1])):
                    max_abs[k] = max(max_abs[k], float((got - ref).abs().max()))
            ok = all(e <= TOL[mode] for e in errs.values())
            del k1, p1, k1p, p1p, k2, k2d, p2, k3, p3, k5, p5, g_re, g_im
            # K4 in both carry types on random magnitudes and carries
            S = torch.rand(b, wc.shape[0], t, generator=gen, device=dev)
            for carry in (torch.float32, torch.bfloat16):
                p_re = randn(b, wc.shape[0], t).to(carry)
                p_im = randn(b, wc.shape[0], t).to(carry)
                k4 = fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)  # tensor cores
                torch.cuda.synchronize()
                r_err, c_err, mag_err, excluded, abs_err = gl_step_errors(
                    fk, k4, x, wc, ws, S, p_re, p_im, hop, MOM)
                tol4 = max(TOL[mode], CARRY_TOL[carry])
                ok4 = r_err <= tol4 and c_err <= tol4 and mag_err <= MAG_TOL[carry]
                ok = ok and ok4
                cname = "fp32" if carry == torch.float32 else "bf16"
                errs[f"K4 {cname} r"], errs[f"K4 {cname} c"] = r_err, c_err
                errs[f"K4 {cname} |c|-S"] = mag_err
                log(f"[check] {mode:8s} {label:16s} K4 {cname} carries: r {r_err:.2e}, "
                    f"c {c_err:.2e} (tol {tol4:g}) on {S.numel() - excluded} of "
                    f"{S.numel()} elements ({excluded} excluded where |n| < 1e-2 "
                    f"rms|n|), max||c|-S|/max S {mag_err:.2e} (tol "
                    f"{MAG_TOL[carry]:g}) {'ok' if ok4 else 'FAIL'}")
                if slice_fp32 and carry == torch.float32:
                    max_abs["gl_step"] = max(max_abs["gl_step"], abs_err)
                del k4, p_re, p_im
            log(f"[check] {mode:8s} {label:16s} B={b} L={length} n_fft={n_fft} "
                f"hop={hop} F={wc.shape[0]} M={m} T={t}: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {TOL[mode]:g}; K4 as above) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"kernel disagrees with its plain version: {mode} {label}")
            del x, sre, sim, S
    config.set_matmul_precision("highest")

    # K1, K2, K4 and K5 (the tensor-core main loop) at shapes off its tiles,
    # and twice: (label, B, L, N, hop, F, M)
    tc_cases = [
        ("slice (b)", 32, 220500 + 2048, 2048, 512, 1025, 128),
        ("T 3 (< one tile)", 2, 2048 + 2 * 512, 2048, 512, 1025, 64),
        ("F 1", 2, 30000, 2048, 512, 1, 1),
        ("F 12, N 256", 4, 20000, 256, 64, 12, 40),
        ("F 84, N 16384", 2, 16384 + 512 * 20, 16384, 512, 84, 300),
        ("F 48, N 8192, hop 128", 2, 8192 + 128 * 300, 8192, 128, 48, 1),
        ("N 5000, hop 100", 2, 9000, 5000, 100, 84, 64),
        ("odd L, hop 441", 3, 66151, 2048, 441, 300, 256),
        ("N 250 (rows off 16 bytes)", 2, 3001, 250, 7, 33, 40),
        ("hop 6 (4-byte pieces)", 2, 3002, 250, 6, 33, 64),
        ("F 1025, M 12 (chroma)", 4, 220500 + 2048, 2048, 512, 1025, 12),
    ]
    carries = {"fp32": torch.float32, "bf16": torch.bfloat16}
    gen = phase_gen("3 tensor cores")
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, b, length, n, hop, f, m in tc_cases:
            x, wc, ws = randn(b, length), randn(f, n) * 0.05, randn(f, n) * 0.05
            fb = torch.rand(m, f, generator=gen, device=dev)
            t = fk.num_frames(length, n, hop)
            S = torch.rand(b, f, t, generator=gen, device=dev)
            prev = {c: (randn(b, f, t).to(dt), randn(b, f, t).to(dt))
                    for c, dt in carries.items()}

            def launch_all():
                out = {"K5": fk.framed_pair(x, wc, ws, hop),
                       "K1": (fk.framed_magnitude(x, wc, ws, hop, eps=1e-8),),
                       "K1 power": (fk.framed_magnitude(x, wc, ws, hop, square=True),),
                       "K2": (fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8),)}
                for c, (p_re, p_im) in prev.items():
                    out[f"K4 {c}"] = fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
                return out
            got = launch_all()
            torch.cuda.synchronize()
            again = launch_all()
            want = {"K5": fk.framed_pair_plain(x, wc, ws, hop),
                    "K1": (fk.framed_magnitude_plain(x, wc, ws, hop, eps=1e-8),),
                    "K1 power": (fk.framed_magnitude_plain(x, wc, ws, hop, square=True),),
                    "K2": (fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8),)}
            errs = {k: max(rel_err(g, w) for g, w in zip(got[k], want[k])) for k in want}
            ok = all(e <= TOL[mode] for e in errs.values())
            for c, dt in carries.items():
                r_err, c_err, mag_err, _, _ = gl_step_errors(
                    fk, got[f"K4 {c}"], x, wc, ws, S, *prev[c], hop, MOM)
                tol4 = max(TOL[mode], CARRY_TOL[dt])
                ok = ok and r_err <= tol4 and c_err <= tol4 and mag_err <= MAG_TOL[dt]
                errs[f"K4 {c} r"], errs[f"K4 {c} c"] = r_err, c_err
                errs[f"K4 {c} |c|-S"] = mag_err
            same = all(torch.equal(g, a) for k in got for g, a in zip(got[k], again[k]))
            ok = ok and same
            log(f"[check] {mode:8s} K1/K2/K4/K5 {label:26s} B={b} L={length} N={n} "
                f"hop={hop} F={f} M={m} T={t}: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {TOL[mode]:g}; K4 carries as above), second launch "
                f"{'bit-equal' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K1/K2/K4/K5 disagree with their plain versions or with "
                     f"themselves: {mode} {label}")
            if mode == "highest" and label == "slice (b)":
                # what "fp32 accuracy" means for the 3xTF32 products: their
                # error against fp64, beside the plain fp32 version's
                sub = slice(0, 4)
                ref = torch.einsum("fn,btn->bft", wc.double(),
                                   x[sub].double().unfold(-1, n, hop))
                e_kernel = rel_err(got["K5"][0][sub], ref)
                e_plain = rel_err(want["K5"][0][sub], ref)
                e_split = rel_err(fk.framed_pair_3xtf32_plain(x[sub], wc, ws, hop)[0], ref)
                e64 = fp64_errors(fk, x[sub], wc, ws, fb, S[sub], *(p[sub] for p in prev["fp32"]),
                                  hop, MOM)
                ok64 = e_kernel <= 4 * e_plain and all(k <= 4 * p for k, p in e64.values())
                log(f"[check] highest  K5 3xTF32 against an fp64 product at (b), 4 clips: "
                    f"kernel {e_kernel:.2e}, plain fp32 version {e_plain:.2e}, plain "
                    f"3xTF32 version {e_split:.2e}; against fp64 functions, K2 (M={m}) "
                    f"kernel {e64['K2'][0]:.2e}, plain {e64['K2'][1]:.2e}; K4 (fp32 "
                    f"carries) kernel {e64['K4'][0]:.2e}, plain {e64['K4'][1]:.2e} "
                    f"(limit 4x the plain fp32 version's) {'ok' if ok64 else 'FAIL'}")
                if not ok64:
                    fail("a 3xTF32 kernel is less accurate than 4x its plain fp32 version")
                del ref
            del x, wc, ws, fb, S, prev, got, again, want
    config.set_matmul_precision("highest")

    # K6 against the plain version and against K1 on the same inputs. The
    # banks: CQT1992v2's default wavelets (84 x 16384, each centred in its
    # row), the same with one entry set at column 0 of the top bin and with
    # its middle group of bins zero, and CQT1992's fp64-composed basis of the
    # same shape, which is dense
    cqt = CQT1992v2(verbose=False, device=dev)  # 84 bins of 16384 samples
    c1992 = CQT1992(fmin=32.7, device=dev)
    n_cqt = cqt.kernel_width
    len_cqt = 22050 * 10 + n_cqt  # 10 s, center-padded
    wc_cqt, ws_cqt = cqt.cqt_kernels_real, cqt.cqt_kernels_imag
    edited = wc_cqt.clone()
    edited[-1, 0] = wc_cqt.abs().max()
    middle = -(-wc_cqt.shape[0] // fk.KCHUNK_GROUP) // 2 * fk.KCHUNK_GROUP
    zero_group = [w.clone() for w in (wc_cqt, ws_cqt)]
    for w in zero_group:
        w[middle:middle + fk.KCHUNK_GROUP] = 0
    banks = {"cqt": (wc_cqt, ws_cqt), "cqt edited": (edited, ws_cqt),
             "cqt zero group": tuple(zero_group),
             "cqt1992": (c1992.combined_real, c1992.combined_imag)}
    for label, key in (("CQT1992v2() default bank", "cqt"),
                       ("CQT1992(fmin=32.7) composed bank", "cqt1992")):
        wc, ws = banks[key]
        got = fk.kchunk_ranges(wc, ws).cpu()
        want = fk.kchunk_ranges_plain(wc, ws).cpu()
        nnz = int(((wc != 0) | (ws != 0)).sum())
        bk = fk.KCHUNK_BK[torch.float32]
        work = sum(-(-int(hi) // bk) - int(lo) // bk for lo, hi in want.tolist() if hi > lo)
        log(f"[bank] {label} {wc.shape[0]} x {wc.shape[1]}: group ranges [k_lo, k_hi) "
            f"of {fk.KCHUNK_GROUP} bins from K6's pre-pass: "
            + " ".join(f"[{lo}, {hi})" for lo, hi in got.tolist())
            + f"; nonzero entries {nnz} of {wc.numel()} ({100 * nnz / wc.numel():.2f}%, "
            f"the structural fill); active group-chunks of {bk} samples {work} of "
            f"{len(want) * -(-wc.shape[1] // bk)} ({100 * work / (len(want) * -(-wc.shape[1] // bk)):.1f}%)")
        if not torch.equal(got, want):
            fail(f"K6's pre-pass ranges differ from the plain ones on {label}: {got} vs {want}")
    # (label, B, L, N, hop, bank): a key of `banks`, or F for a dense random bank
    k6_cases = [
        ("CQT B=32", 32, len_cqt, n_cqt, 512, "cqt"),
        ("CQT B=1", 1, len_cqt, n_cqt, 512, "cqt"),
        ("CQT, top bin col 0 set", 2, len_cqt, n_cqt, 512, "cqt edited"),
        ("CQT, middle group 0", 2, len_cqt, n_cqt, 512, "cqt zero group"),
        ("CQT1992 dense", 4, len_cqt, n_cqt, 512, "cqt1992"),
        ("84 x 8192, hop 512", 2, 16384, 8192, 512, 84),
        ("64 x 4096, hop 320", 1, 12000, 4096, 320, 64),
        ("hop 441", 2, 40000, 8192, 441, 96),
        ("F 1", 2, 30000, 4096, 512, 1),
        ("F 127", 2, 30000, 4096, 512, 127),
        ("F 128", 2, 30000, 4096, 512, 128),
        ("N 5000, hop 100", 2, 9000, 5000, 100, 84),
        ("T 3 (< one tile)", 2, 4300, 4096, 64, 33),
    ]
    gen = phase_gen("3 K6")
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, b, length, n, hop, bank in k6_cases:
            if isinstance(bank, str):
                wc, ws = banks[bank]
            else:
                wc, ws = randn(bank, n) * 0.05, randn(bank, n) * 0.05
            x = randn(b, length)
            errs = {}
            for tag, kw in (("mag", dict(eps=1e-8)), ("power", dict(square=True))):
                k6 = fk.framed_magnitude_kchunk(x, wc, ws, hop, **kw)
                torch.cuda.synchronize()
                k1 = fk.framed_magnitude(x, wc, ws, hop, **kw)
                torch.cuda.synchronize()
                p6 = fk.framed_magnitude_plain(x, wc, ws, hop, **kw)
                errs[f"K6 {tag}"] = rel_err(k6, p6)
                errs[f"K6 {tag} vs K1"] = rel_err(k6, k1)
                if mode == "highest" and label == "CQT B=32":
                    max_abs["framed_magnitude_kchunk"] = max(
                        max_abs["framed_magnitude_kchunk"],
                        float((k6 - p6).abs().max()))
                if mode == "highest" and tag == "mag" and bank in ("cqt", "cqt1992") and b > 1:
                    # fp32 accuracy of the 3xTF32 products: against fp64,
                    # beside the plain fp32 version's error
                    sub = slice(0, 4)
                    frames = x[sub].double().unfold(-1, n, hop)
                    re = torch.einsum("fn,btn->bft", wc.double(), frames)
                    im = torch.einsum("fn,btn->bft", ws.double(), frames)
                    ref = (re * re + im * im + 1e-8).sqrt()
                    e_kernel, e_plain = rel_err(k6[sub], ref), rel_err(p6[sub], ref)
                    ok64 = e_kernel <= 4 * e_plain
                    log(f"[check] highest  K6 3xTF32 against the fp64 magnitude, {label}, "
                        f"{ref.shape[0]} clips: kernel {e_kernel:.2e}, plain fp32 version "
                        f"{e_plain:.2e} (limit 4x) {'ok' if ok64 else 'FAIL'}")
                    if not ok64:
                        fail("K6 in fp32 storage is less accurate than 4x its plain fp32 version")
                    del frames, re, im, ref
                again = fk.framed_magnitude_kchunk(x, wc, ws, hop, **kw)
                if not torch.equal(k6, again):
                    fail(f"K6 is not deterministic: {mode} {label} {tag}")
                del k6, k1, p6, again
            same = torch.equal(fk.kchunk_ranges(wc, ws).cpu(),
                               fk.kchunk_ranges_plain(*(w.to(config.storage_dtype())
                                                        for w in (wc, ws))).cpu())
            t = fk.num_frames(length, n, hop)
            splits = fk.kchunk_plan(b, t, n)
            ok = all(e <= TOL[mode] for e in errs.values()) and same
            log(f"[check] {mode:8s} K6 {label:22s} B={b} L={length} N={n} hop={hop} "
                f"F={wc.shape[0]} T={t} splits={splits}: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {TOL[mode]:g}), second launch bit-equal, pre-pass ranges "
                f"{'equal' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K6 disagrees with its plain version, K1 or the plain ranges: "
                     f"{mode} {label}")
            del x
        # K3 at the flat CQT inverse's shape: F=84 bins, N=16384, hop 128
        sre, sim = randn(2, 84, 300), randn(2, 84, 300)
        kc, ks = randn(84, n_cqt) / n_cqt, randn(84, n_cqt) / n_cqt
        k3 = fk.synthesis_ola(sre, sim, kc, ks, 128)
        torch.cuda.synchronize()
        e3 = rel_err(k3, fk.synthesis_ola_plain(sre, sim, kc, ks, 128))
        log(f"[check] {mode:8s} K3 at the flat CQT inverse's shape B=2 F=84 T=300 "
            f"N={n_cqt} hop=128: {e3:.2e} (tol {TOL[mode]:g}) "
            f"{'ok' if e3 <= TOL[mode] else 'FAIL'}")
        if e3 > TOL[mode]:
            fail(f"K3 disagrees with its plain version at the CQT inverse's shape: {mode}")
        del sre, sim, kc, ks, k3
    config.set_matmul_precision("highest")

    # K3 on the tensor cores: against the plain version, twice for bit
    # equality, and in fp32 storage against fp64 beside the plain fp32
    # version: (label, B, F, T, N, hop); N a name takes that inverse's dual
    # bank: (h)'s flat one, (n)'s collapsed pyramid at 48 bins / hop 128,
    # and the collapsed pyramid of CQT2010v2() at its defaults (84 bins,
    # hop 512)
    cqt_h = CQT1992v2(sr=22050, fmin=55, n_bins=48, hop_length=128,
                      output_format="Complex", verbose=False, device=dev)
    c2010_n = CQT2010v2(**INV_CFG, output_format="Complex", verbose=False, device=dev)
    c2010_d = CQT2010v2(output_format="Complex", verbose=False, device=dev)
    t0 = time.perf_counter()
    duals = {"(h)": cqt_h._dual_kernels("librosa", 1e-3),
             "(n) 48 bins": c2010_n._pyramid_dual_kernels("librosa", 1e-3)[:2]}
    t1 = time.perf_counter()
    duals["(n) default"] = c2010_d._pyramid_dual_kernels("librosa", 1e-3)[:2]
    log(f"[bank] pyramid dual banks built on the host in fp64: CQT2010v2 at 48 bins / "
        f"hop 128 {tuple(duals['(n) 48 bins'][0].shape)} with (h)'s flat bank in "
        f"{t1 - t0:.2f} s, CQT2010v2() at its defaults {tuple(duals['(n) default'][0].shape)} "
        f"in {time.perf_counter() - t1:.2f} s")
    k3_cases = [
        ("slice (b)", 32, 1025, 431, 2048, 512),
        ("(e) 1024/256", 32, 513, 862, 1024, 256),
        ("hop 160", 4, 257, 300, 512, 160),
        ("hop 441", 4, 1025, 150, 2048, 441),
        ("hop 3", 2, 201, 1300, 400, 3),
        ("(h) inverse", 4, 48, 1723, "(h)", 128),
        ("(n) pyramid 48", 4, 48, 1723, "(n) 48 bins", 128),
        ("(n) pyramid 84", 4, 84, 431, "(n) default", 512),
    ]
    sums = set()  # the fp32 running sums launched: compensated or not
    gen = phase_gen("3 K3")
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, b, f, t, n, hop in k3_cases:
            if isinstance(n, str):
                kc, ks = duals[n]
                f, n = kc.shape
            else:
                kc, ks = randn(f, n) / n, randn(f, n) / n
            sre, sim = randn(b, f, t), randn(b, f, t)
            k3 = fk.synthesis_ola(sre, sim, kc, ks, hop)
            torch.cuda.synchronize()
            same = torch.equal(k3, fk.synthesis_ola(sre, sim, kc, ks, hop))
            plain = fk.synthesis_ola_plain(sre, sim, kc, ks, hop)
            err = rel_err(k3, plain)
            ok = err <= TOL[mode] and same
            extra = ""
            if mode == "highest":
                ref = synthesis_fp64(sre, sim, kc, ks, hop)
                e_kernel, e_plain = rel_err(k3, ref), rel_err(plain, ref)
                sub = slice(0, 2)
                e_split = rel_err(fk.synthesis_ola_3xtf32_plain(sre[sub], sim[sub], kc, ks, hop),
                                  ref[sub])
                ok = ok and e_kernel <= 4 * e_plain
                kahan = fk.synthesis_compensated(f, n, hop)
                sums.add(kahan)
                extra = (f"; {'compensated' if kahan else 'plain'} fp32 sum; "
                         f"against fp64: kernel {e_kernel:.2e}, plain fp32 version "
                         f"{e_plain:.2e} (limit 4x), plain 3xTF32 version (2 clips) "
                         f"{e_split:.2e}")
                if label == "slice (b)":
                    max_abs["synthesis_ola"] = max(max_abs["synthesis_ola"],
                                                   float((k3 - plain).abs().max()))
                del ref
            log(f"[check] {mode:8s} K3 {label:14s} B={b} F={f} T={t} N={n} hop={hop}: "
                f"vs plain {err:.2e} (tol {TOL[mode]:g}), second launch "
                f"{'bit-equal' if same else 'DIFFERS'}{extra} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K3 disagrees with its plain version, fp64 or itself: {mode} {label}")
            del sre, sim, kc, ks, k3, plain
    if sums != {False, True}:
        fail(f"K3's cases launched only one kind of fp32 sum: {sums}")
    config.set_matmul_precision("highest")
    # K3's FFT route, on the products of an iSTFT's own factors: against its
    # plain mirror, the dense plain version and fp64 (at most the plain
    # version's error), twice for bit equality
    for label, b, t, n, hop, stack in (("(e) 1024/256", 32, 862, 1024, 256, False),
                                       ("stream step", 128, 4, 1024, 256, True),
                                       ("slice (b)", 32, 431, 2048, 512, True),
                                       ("hop 127", 4, 300, 512, 127, False),
                                       ("hop = n_fft", 3, 17, 4096, 4096, True)):
        ist_r = iSTFT(n_fft=n, hop_length=hop, verbose=False, device=dev)
        kc, ks = fk.synthesis_kernels(ist_r.kernel_cos, ist_r.kernel_sin, ist_r.window_mask)
        f = n // 2 + 1
        sre, sim = randn(b, f, t), randn(b, f, t)
        if stack:  # the halves of a (B, F, T, 2) stack, as iSTFT's callers hand them
            X = torch.stack((sre, sim), -1)
            sre, sim = X[..., 0], X[..., 1]
        fk.reset_launches()
        k3 = fk.synthesis_ola(sre, sim, kc, ks, hop)
        torch.cuda.synchronize()
        routed = fk.LAUNCHES["synthesis_ola_fft"] == 1 and fk.LAUNCHES["synthesis_ola"] == 0
        same = torch.equal(k3, fk.synthesis_ola(sre, sim, kc, ks, hop))
        mirror = fk.synthesis_ola_fft_plain(sre, sim, ist_r.window_mask / n, hop)
        plain = fk.synthesis_ola_plain(sre, sim, kc, ks, hop)
        ref = synthesis_fp64(sre, sim, kc, ks, hop)
        e_mirror, e_plain = rel_err(k3, mirror), rel_err(k3, plain)
        e_kernel, e_plain64 = rel_err(k3, ref), rel_err(plain, ref)
        ok = routed and same and e_mirror <= 1e-6 and e_plain <= TOL["highest"] \
            and e_kernel <= 4 * e_plain64
        if label == "(e) 1024/256":
            max_abs["synthesis_ola_fft"] = float((k3 - mirror).abs().max())
        log(f"[check] highest  K3 FFT {label:12s} B={b} T={t} N={n} hop={hop}"
            f"{' (stack halves)' if stack else ''}: vs its mirror {e_mirror:.2e} (tol 1e-06), "
            f"vs dense plain {e_plain:.2e}; against fp64: kernel {e_kernel:.2e}, plain "
            f"fp32 version {e_plain64:.2e} (limit 4x); second launch {'bit-equal' if same else 'DIFFERS'}"
            f"{'' if routed else '; NOT ROUTED'} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K3's FFT route disagrees with its mirror, fp64 or itself: {label}")
        del sre, sim, k3, mirror, plain, ref
    # K4's FFT route, on a transform's own basis with fp32 carries: against
    # its plain mirror and the pair (K5) and the update, r everywhere and c
    # where |n| >= 1e-2 rms|n| (gl_step_errors), twice for bit equality
    gen = phase_gen("3 K4")
    for label, b, t, n, hop in (("(e) 1024/256", 32, 862, 1024, 256),
                                ("(f) 2048/512", 32, 431, 2048, 512),
                                ("hop 441", 3, 101, 2048, 441),
                                ("hop 127", 4, 300, 512, 127),
                                ("N 8192, hop 2048", 2, 9, 8192, 2048)):
        wc, ws = fourier(n)
        f = n // 2 + 1
        x = randn(b, n + hop * (t - 1))
        S = torch.rand(b, f, t, generator=gen, device=dev)
        p_re, p_im = randn(b, f, t), randn(b, f, t)
        fk.reset_launches()
        k4 = fk.gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
        torch.cuda.synchronize()
        routed = fk.LAUNCHES["gl_step_fft"] == 1 and fk.LAUNCHES["framed_pair"] == 0
        same = all(torch.equal(a, c) for a, c in
                   zip(k4, fk.gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)))
        mirror = fk.gl_step_fft_plain(x, wc, ws, S, p_re, p_im, hop, MOM)
        pair = fk.gl_update(*fk.framed_pair(x, wc, ws, hop), S, p_re, p_im, MOM)
        e_mirror = max(rel_err(k4[k], mirror[k]) for k in (2, 3))  # r; c below
        r_err, c_err, mag_err, excluded, _ = gl_step_errors(fk, k4, x, wc, ws, S, p_re,
                                                            p_im, hop, MOM)
        e_pair = max(rel_err(k4[k], pair[k]) for k in (2, 3))
        ok = (routed and same and e_mirror <= 1e-5 and e_pair <= TOL["highest"]
              and r_err <= TOL["highest"] and c_err <= TOL["highest"]
              and mag_err <= MAG_TOL[torch.float32])
        if label == "(e) 1024/256":
            max_abs["gl_step_fft"] = max(float((k4[k] - mirror[k]).abs().max()) for k in (2, 3))
        log(f"[check] highest  K4 FFT {label:16s} B={b} T={t} N={n} hop={hop}: r vs its mirror "
            f"{e_mirror:.2e} (tol 1e-05), r vs the pair {e_pair:.2e}; vs the plain step: r "
            f"{r_err:.2e}, c {c_err:.2e} on {S.numel() - excluded} of {S.numel()} elements, "
            f"max||c|-S|/max S {mag_err:.2e}; second launch "
            f"{'bit-equal' if same else 'DIFFERS'}{'' if routed else '; NOT ROUTED'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4's FFT route disagrees with its mirror, the pair or itself: {label}")
        del x, S, p_re, p_im, k4, mirror, pair
    # the inverse Mel's NNLS kernel (the seed and every step, one launch) on a
    # transform's own basis: against its plain mirror and the dense products
    # of the plain route, twice for bit equality; at (e)'s shape (862 frames:
    # a last block of 30 columns), a step fewer on mels read through a copy,
    # one frame, 128 mels at n_fft 2048 and an HTK basis
    gen = phase_gen("3 NNLS")
    config.set_matmul_precision("highest")
    mel80 = dict(sr=22050, n_fft=1024, n_mels=80, fmax=8000.0)
    for label, b, t, n_iter, layout, kw in (
            ("(e) 80 mels", 32, 862, 64, "contiguous", mel80),
            ("(e) 63 steps", 32, 862, 63, "transposed", mel80),
            ("one frame", 3, 1, 64, "contiguous", mel80),
            ("128 mels, n_fft 2048", 4, 431, 64, "contiguous",
             dict(sr=22050, n_fft=2048, n_mels=128)),
            ("HTK 40 mels", 5, 40, 17, "transposed", dict(sr=16000, n_fft=512, n_mels=40,
                                                          htk=True))):
        inv_n = InverseMelSpectrogram(hop_length=256, verbose=False, device=dev, **kw)
        basis, pinv, step = inv_n.mel_basis, inv_n.mel_pinv, inv_n._step
        spectra = torch.rand(b, basis.shape[1], t, generator=gen, device=dev) ** 4
        mel_n = torch.einsum("mf,bft->bmt", basis, spectra)
        if layout == "transposed":
            mel_n = mel_n.transpose(1, 2).contiguous().transpose(1, 2)
        with torch.no_grad():
            fk.reset_launches()
            got = fk.nnls(basis, pinv, mel_n, step, n_iter)
            torch.cuda.synchronize()
            routed = fk.LAUNCHES["nnls_banded"] == 1
            same = torch.equal(got, fk.nnls(basis, pinv, mel_n, step, n_iter))
            mirror = fk.nnls_banded_plain(basis, pinv, mel_n, step, n_iter)
            products = fk.nnls_plain(basis, pinv, mel_n, step, n_iter)
        e_mirror, e_products = rel_err(got, mirror), rel_err(got, products)
        ok = routed and same and e_mirror <= 1e-5 and e_products <= 1e-5
        if label == "(e) 80 mels":
            max_abs["nnls_banded"] = float((got - mirror).abs().max())
        log(f"[check] highest  NNLS {label:22s} B={b} T={t} M={basis.shape[0]} "
            f"F={basis.shape[1]} steps={n_iter} ({layout} mels): vs its mirror {e_mirror:.2e}, "
            f"vs the products {e_products:.2e} (tol 1e-05); second launch "
            f"{'bit-equal' if same else 'DIFFERS'}{'' if routed else '; NOT ROUTED'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the NNLS kernel disagrees with its mirror, the products or itself: {label}")
        del inv_n, spectra, mel_n, got, mirror, products
    # a banded basis whose bins meet three rows: the kernel reads those bins'
    # entries from the band's values, not from their headers
    basis = torch.zeros(12, 42, device=dev)
    for m in range(12):
        basis[m, 3 * m:3 * m + 9] = torch.rand(9, generator=gen, device=dev)
    pinv = torch.linalg.pinv(basis.double()).float()
    fk.mark_own(basis, pinv)
    mel_n = torch.einsum("mf,bft->bmt", basis,
                         torch.rand(3, 42, 70, generator=gen, device=dev) ** 4)
    with torch.no_grad():
        fk.reset_launches()
        got = fk.nnls(basis, pinv, mel_n, 0.05, 16)
        torch.cuda.synchronize()
        routed = fk.LAUNCHES["nnls_banded"] == 1
        e_mirror = rel_err(got, fk.nnls_banded_plain(basis, pinv, mel_n, 0.05, 16))
        e_products = rel_err(got, fk.nnls_plain(basis, pinv, mel_n, 0.05, 16))
    ok = routed and e_mirror <= 1e-5 and e_products <= 1e-5
    log(f"[check] highest  NNLS three rows a bin      B=3 T=70 M=12 F=42 steps=16: vs its mirror "
        f"{e_mirror:.2e}, vs the products {e_products:.2e} (tol 1e-05)"
        f"{'' if routed else '; NOT ROUTED'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the NNLS kernel disagrees with its mirror or the products on bins of three rows")
    del basis, pinv, mel_n, got

    # ------------------------------------------------- 4. the serving slice --
    # a numpy rfft oracle at a small input first
    xs = np.random.RandomState(0).randn(1, 16000).astype(np.float32)
    st_small = STFT(n_fft=1024, hop_length=256, output_format="Magnitude",
                    verbose=False, device=dev)
    mag = st_small(xs).cpu().numpy()[0]
    xp = np.pad(xs[0].astype(np.float64), 512, mode="reflect")
    n_t = (len(xp) - 1024) // 256 + 1
    win = st_small.window_mask.cpu().numpy().astype(np.float64)
    frames = np.stack([xp[i * 256:i * 256 + 1024] for i in range(n_t)]) * win
    oracle = np.abs(np.fft.rfft(frames, axis=1)).T
    e = float(np.abs(mag - oracle).max() / oracle.max())
    log(f"[oracle] STFT magnitude 1024/256 vs numpy rfft: rel err {e:.2e}")
    if e > 1e-4:
        fail("STFT disagrees with the numpy rfft oracle")

    launches = {k: 0 for k in fk.LAUNCHES}
    results = {}

    def counted(label, fn, expect_shape, expect=None):
        """Run a path with the counts zeroed; check its outputs' shape and
        finiteness and, where given, its exact launch counts."""
        fk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(fk.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        outs = out if isinstance(out, list) else [out]
        for o in outs:
            if tuple(o.shape) != expect_shape:
                fail(f"{label}: shape {tuple(o.shape)} != {expect_shape}")
            if not torch.isfinite(o).all():
                fail(f"{label}: non-finite output")
        if expect is not None and counts != {k: expect.get(k, 0) for k in counts}:
            fail(f"{label}: launches {counts}, expected {expect}")
        return outs, dt, counts

    def log_profile(key, fn):
        """One call of a path under ``torch.profiler``: wall time, device busy
        and idle share, and the six kernels that took most of it. Fails if a
        kernel the call launched (counted in ``LAUNCHES``) is missing from
        the profile twice running: a trace that lost a kernel's events would
        misstate where the time goes."""
        for attempt in (1, 2):
            fk.reset_launches()
            wall, kernels = profile_path(fn)
            missing = [k for k, v in fk.LAUNCHES.items()
                       if v and not any(PROFILE_NAMES[k] in name for name in kernels)]
            if not missing:
                break
            log(f"[profile] ({key}) attempt {attempt}: launched but not in the "
                f"profile: {missing}; the profile holds "
                + "; ".join(f"{name[:50]} x{n}" for name, (_, n) in kernels.items()))
        if missing:
            fail(f"({key}): the profile misses kernels it launched: {missing}")
        busy = sum(k_ms for k_ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[profile] ({key}) one call under torch.profiler: wall {wall:.2f} ms, "
            + (f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
               f"{100 * (1 - busy / wall):.1f}%; by kernel: "
               + "; ".join(f"{name[:60]} {k_ms:.2f} ms x{n}" for name, (k_ms, n) in top)
               if kernels else "device time not measured (no CUDA events)"))

    def plain_path(fn):
        config.set_use_kernels(False)
        try:
            return fn()
        finally:
            config.set_use_kernels(True)

    def drive(label, fn, expect_shape, tol=None, expect=None):
        """Run a path with the counts zeroed, then the same path with the
        kernels off (the plain path) for comparison."""
        outs, dt, counts = counted(label, fn, expect_shape, expect)
        ref = plain_path(fn)
        refs = ref if isinstance(ref, list) else [ref]
        err = max(rel_err(o, r) for o, r in zip(outs, refs))
        tol = TOL[config.get_config().matmul_precision] if tol is None else tol
        log(f"[path] {label}: {dt * 1e3:.1f} ms, launches {counts}, "
            f"rel err vs plain path {err:.2e} (tol {tol:g})")
        if err > tol:
            fail(f"{label}: kernel path disagrees with the plain path")
        return outs, dt

    sr_a, sr_b, batch, secs = 16000, 22050, 32, 10
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        # (a) the flagship classifier: 4 requests of 32 x 10 s
        gen = phase_gen(f"a {mode}")
        model = SpectrogramClassifier(n_classes=10, sr=sr_a, n_fft=1024,
                                      hop_length=256, n_mels=64, seed=0,
                                      device=dev)
        requests = [randn(batch, sr_a * secs) for _ in range(4)]
        with torch.no_grad():
            model(None, requests[0])  # warm-up outside the counted run
            outs, dt = drive(f"(a) classifier {mode} x4 requests",
                             lambda: [model(None, r) for r in requests],
                             (batch, 10))
            log_profile(f"a, {mode}, one request", lambda: model(None, requests[0]))
        results[f"a_{mode}_audio_s_per_s"] = 4 * batch * secs / dt
        log(f"[serve] (a) {mode}: 4 requests of {batch} x {secs} s in "
            f"{dt * 1e3:.1f} ms = {4 * batch * secs / dt:.1f} audio-s/s")

        # (b) STFT Magnitude 2048/512 and (c) Mel 128 at 32 x 10 s, 22.05 kHz
        gen = phase_gen(f"b {mode}")
        xb = randn(batch, sr_b * secs)
        st = STFT(n_fft=2048, hop_length=512, output_format="Magnitude",
                  verbose=False, device=dev)
        mel = MelSpectrogram(sr=sr_b, n_fft=2048, hop_length=512, n_mels=128,
                             verbose=False, device=dev)
        with torch.no_grad():
            drive(f"(b) STFT Magnitude {mode}", lambda: st(xb), (batch, 1025, 431))
            drive(f"(c) MelSpectrogram {mode}", lambda: mel(xb), (batch, 128, 431))
            ms_b = cuda_ms(lambda: st(xb))
            ms_c = cuda_ms(lambda: mel(xb))
            log_profile(f"b, {mode}", lambda: st(xb))
            log_profile(f"c, {mode}", lambda: mel(xb))
        results[f"b_{mode}_audio_s_per_s"] = batch * secs / (ms_b / 1e3)
        results[f"c_{mode}_audio_s_per_s"] = batch * secs / (ms_c / 1e3)
        log(f"[serve] (b) {mode}: {ms_b:.3f} ms per batch = "
            f"{batch * secs / (ms_b / 1e3):.1f} audio-s/s; (c) {ms_c:.3f} ms = "
            f"{batch * secs / (ms_c / 1e3):.1f} audio-s/s")

        # (w) Whisper large-v3's front end on 32 x 30 s windows: in fp32 one
        # launch of K2's mixed-radix FFT route at n_fft 400 and no dense K2;
        # in bf16 dense K2
        gen = phase_gen(f"w {mode}")
        xw = randn(batch, 480000)
        whisper = WhisperLogMel(device=dev)
        with torch.no_grad():
            whisper(xw)  # warm-up outside the counted run
            drive(f"(w) WhisperLogMel {mode}", lambda: whisper(xw), (batch, 128, 3000),
                  expect={k2_route(mode): 1})
            ms_w = cuda_ms(lambda: whisper(xw))
        results[f"w_{mode}_audio_s_per_s"] = batch * 30 / (ms_w / 1e3)
        log(f"[serve] (w) {mode}: {ms_w:.3f} ms per batch = "
            f"{batch * 30 / (ms_w / 1e3):.1f} audio-s/s")
        del xw, whisper
    config.set_matmul_precision("highest")

    # (d) iSTFT and STFT.inverse round trips of (b)'s Complex output
    gen = phase_gen("d")
    xb = randn(batch, sr_b * secs)
    stc = STFT(n_fft=2048, hop_length=512, iSTFT=True, verbose=False, device=dev)
    ist = iSTFT(n_fft=2048, hop_length=512, verbose=False, device=dev)
    with torch.no_grad():
        X = stc(xb)
        outs, _ = drive("(d) iSTFT + STFT.inverse round trip",
                        lambda: [ist(X, onesided=True, length=xb.shape[1]),
                                 stc.inverse(X, length=xb.shape[1])],
                        tuple(xb.shape))
    rt = max(float((o - xb).abs().max()) for o in outs)
    log(f"[path] (d) round-trip max abs error {rt:.2e} (tol 1e-3)")
    if rt > 1e-3:
        fail("iSTFT round trip error above 1e-3")

    # (e) mel -> audio and (f) Griffin-Lim on a seeded harmonic batch
    xh = harmonic_batch(batch, sr_b * secs, sr_b, 0, dev)
    mel_e = MelSpectrogram(sr=sr_b, n_fft=1024, hop_length=256, n_mels=80,
                           verbose=False, device=dev)
    st_e = STFT(n_fft=1024, hop_length=256, output_format="Magnitude",
                verbose=False, device=dev)
    st_f = STFT(n_fft=2048, hop_length=512, output_format="Magnitude",
                verbose=False, device=dev)

    def inverse_mel(n_iter):
        return InverseMelSpectrogram(sr=sr_b, n_fft=1024, hop_length=256,
                                     n_mels=80, n_iter_nnls=64, n_iter=n_iter,
                                     verbose=False, device=dev)

    def griffin_lim(n_iter):
        return Griffin_Lim(n_fft=2048, hop_length=512, n_iter=n_iter,
                           iter_precision="highest", device=dev)

    def spectral_convergence(st, audio, target):
        rec = st(audio)
        return float(torch.linalg.vector_norm(rec - target)
                     / torch.linalg.vector_norm(target))

    shape_e, shape_f = (batch, 861 * 256), (batch, 430 * 512)
    with torch.no_grad():
        inv2, gl2 = inverse_mel(2), griffin_lim(2)
        drive("(e) mel -> audio, 2 Griffin-Lim iterations",
              lambda: inv2(mel_e(xh)), shape_e, tol=GL_TOL["default"],
              expect={k2_route("highest"): 1, "gl_step": 2, "synthesis_ola": 2,
                      "synthesis_ola_fft": 1, "nnls_banded": 1})
        S_f = st_f(xh)
        drive("(f) Griffin-Lim fp32, 2 iterations", lambda: gl2(S_f), shape_f,
              tol=GL_TOL["highest"],
              expect={"gl_step_fft": 2, "synthesis_ola_fft": 3})

        n_iter = 32
        inv, gl = inverse_mel(n_iter), griffin_lim(n_iter)
        mel = mel_e(xh)
        target_e = inv.mel_to_power(inv.params, mel).sqrt()
        for label, fn, shape, st, target, expect in (
                ("(e) mel -> audio", lambda: inv(mel_e(xh)), shape_e, st_e,
                 target_e, {k2_route("highest"): 1, "gl_step": n_iter,
                            "synthesis_ola": n_iter, "synthesis_ola_fft": 1,
                            "nnls_banded": 1}),
                ("(f) Griffin-Lim fp32", lambda: gl(S_f), shape_f, st_f, S_f,
                 {"gl_step_fft": n_iter, "synthesis_ola_fft": n_iter + 1})):
            (audio,), dt, counts = counted(label, fn, shape, expect)
            sc = spectral_convergence(st, audio, target)
            sc_plain = spectral_convergence(st, plain_path(fn), target)
            ms = cuda_ms(fn, reps=3, warmup=1)
            key = label[1]
            results[f"{key}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            log(f"[path] {label}, {n_iter} iterations: {dt * 1e3:.1f} ms, "
                f"launches {counts}; spectral convergence {sc:.4f}, plain path "
                f"{sc_plain:.4f} (|diff| tol {SC_DELTA}, ceiling {SC_CEILING})")
            log(f"[serve] ({key}) {batch} x {secs} s in {ms:.3f} ms (CUDA events, "
                f"median of 3) = {batch * secs / (ms / 1e3):.1f} audio-s/s")
            if abs(sc - sc_plain) > SC_DELTA or sc > SC_CEILING:
                fail(f"{label}: spectral convergence {sc} (plain {sc_plain})")
            log_profile(key, fn)
            if key == "e":
                rt = float(torch.linalg.vector_norm(mel_e(audio) - mel)
                           / torch.linalg.vector_norm(mel))
                results["e_mel_round_trip"] = rt
                log(f"[path] (e) mel-domain round-trip error {rt:.4f}")
        # the inversion cell's transform (fp32 carries, power 1, 8 kHz) with
        # the counts zeroed: its NNLS is one launch of the NNLS kernel and no
        # cuBLAS product runs in the call
        gen = phase_gen("e NNLS")
        inv_c = InverseMelSpectrogram(sr=sr_b, n_fft=1024, hop_length=256, n_mels=80,
                                      fmax=8000.0, power=1.0, n_iter=2,
                                      iter_precision="highest", verbose=False, device=dev)
        mel_c = mel_e(xh).sqrt()
        phase_c = torch.rand(batch, 513, mel_c.shape[-1], generator=gen, device=dev)
        drive("(e) the inversion cell's transform, 2 iterations",
              lambda: inv_c(mel_c, rand_phase=phase_c), shape_e, tol=GL_TOL["highest"],
              expect={"nnls_banded": 1, "gl_step_fft": 2, "synthesis_ola_fft": 3})
        _, kernels_c = profile_path(lambda: inv_c(mel_c, rand_phase=phase_c))
        products_c = [k for k in kernels_c if "gemm" in k]
        log(f"[path] (e) the inversion cell's transform under torch.profiler: NNLS kernels "
            f"{[k[:40] for k in kernels_c if 'nnls_banded' in k]}, cuBLAS products "
            f"{products_c or 'none'}")
        if products_c or not any("nnls_banded_kernel" in k for k in kernels_c):
            fail("(e): the inversion's NNLS did not run as its one kernel")
        del inv, gl, inv2, gl2, mel, target_e, S_f, xh, inv_c, mel_c, phase_c

    # a numpy oracle for the CQT through K6: 1 s at the default bank
    xs = np.random.RandomState(1).randn(1, 22050).astype(np.float32)
    with torch.no_grad():
        fk.reset_launches()
        got = cqt(xs).cpu().numpy()[0]
    if fk.LAUNCHES["framed_magnitude_kchunk"] != 1:
        fail("the default CQT1992v2 Magnitude did not go through K6")
    xp = np.pad(xs[0].astype(np.float64), n_cqt // 2, mode="reflect")
    n_t = (len(xp) - n_cqt) // 512 + 1
    frames = np.stack([xp[i * 512:i * 512 + n_cqt] for i in range(n_t)])
    bank = (cqt.cqt_kernels_real.cpu().numpy().astype(np.float64)
            - 1j * cqt.cqt_kernels_imag.cpu().numpy().astype(np.float64))
    oracle = np.abs(bank @ frames.T) * np.sqrt(cqt.lenghts.cpu().numpy())[:, None]
    e = float(np.abs(got - oracle).max() / oracle.max())
    log(f"[oracle] CQT1992v2 magnitude (84 x {n_cqt}, hop 512) vs numpy fp64: "
        f"rel err {e:.2e}")
    if e > 1e-4:
        fail("CQT1992v2 disagrees with the numpy oracle")

    # (g) CQT1992v2 at its defaults on 32 x 10 s and on one clip; (h) its
    # Complex output
    gen = phase_gen("g")
    xg = randn(batch, sr_b * secs)
    x1 = xg[:1].contiguous()
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        with torch.no_grad():
            drive(f"(g) CQT1992v2 Magnitude {mode}, {batch} x {secs} s",
                  lambda: cqt(xg), (batch, 84, 431),
                  expect={"framed_magnitude_kchunk": 1})
            drive(f"(g) CQT1992v2 Magnitude {mode}, 1 x {secs} s",
                  lambda: cqt(x1), (1, 84, 431),
                  expect={"framed_magnitude_kchunk": 1})
            ms_g = cuda_ms(lambda: cqt(xg))
            ms_g1 = cuda_ms(lambda: cqt(x1))
            log_profile(f"g, {mode}", lambda: cqt(xg))
            log_profile(f"g, {mode}, one clip", lambda: cqt(x1))
        results[f"g_{mode}_audio_s_per_s"] = batch * secs / (ms_g / 1e3)
        results[f"g1_{mode}_audio_s_per_s"] = secs / (ms_g1 / 1e3)
        log(f"[serve] (g) {mode}: {batch} x {secs} s in {ms_g:.3f} ms = "
            f"{batch * secs / (ms_g / 1e3):.1f} audio-s/s; one request of 1 x "
            f"{secs} s in {ms_g1:.3f} ms = {secs / (ms_g1 / 1e3):.1f} audio-s/s")
    config.set_matmul_precision("highest")
    with torch.no_grad():
        drive("(h) CQT1992v2 Complex", lambda: cqt(xg, output_format="Complex"),
              (batch, 84, 431, 2), expect={"framed_pair": 1})
        # Complex -> .inverse where the hop respects the shortest atom
        xt = inband_tones(batch, sr_b * secs, sr_b, 0, dev)
        (rec,), dt = drive(
            "(h) CQT1992v2 Complex -> inverse, 48 bins, hop 128",
            lambda: cqt_h.inverse(cqt_h(xt), length=xt.shape[1]),
            tuple(xt.shape), tol=1e-3,
            expect={"framed_pair": 1, "synthesis_ola": 1})
        snr = interior_snr_db(xt, rec)
        ms_h = cuda_ms(lambda: cqt_h.inverse(cqt_h(xt), length=xt.shape[1]))
        log_profile("h", lambda: cqt_h.inverse(cqt_h(xt), length=xt.shape[1]))
    results["h_round_trip_snr_db"] = snr
    results["h_audio_s_per_s"] = batch * secs / (ms_h / 1e3)
    log(f"[path] (h) round trip interior SNR {snr:.1f} dB (limit > 40 dB); "
        f"{batch} x {secs} s in {ms_h:.3f} ms = "
        f"{batch * secs / (ms_h / 1e3):.1f} audio-s/s")
    if not snr > 40:
        fail(f"(h) CQT round trip SNR {snr} dB is not above 40 dB")
    del rec, xt

    # (i) the pyramid: CQT2010v2 and VQT at their defaults, one pair launch
    # per octave
    c2010 = CQT2010v2(verbose=False, device=dev)
    vqt0 = VQT(verbose=False, device=dev)
    vqt2 = VQT(gamma=2, verbose=False, device=dev)
    octaves = {"framed_pair": c2010.n_octaves}
    with torch.no_grad():
        (out_c,), _ = drive("(i) CQT2010v2", lambda: c2010(xg), (batch, 84, 431),
                            expect=octaves)
        (out_v,), _ = drive("(i) VQT gamma=0", lambda: vqt0(xg), (batch, 84, 431),
                            expect=octaves)
        drive("(i) VQT gamma=2", lambda: vqt2(xg), (batch, 84, 431), expect=octaves)
        if not torch.equal(out_c, out_v):
            fail("(i) VQT(gamma=0) differs from CQT2010v2")
        ms_c = cuda_ms(lambda: c2010(xg))
        ms_v = cuda_ms(lambda: vqt2(xg))
        log_profile("i, CQT2010v2", lambda: c2010(xg))
    results["i_cqt2010v2_audio_s_per_s"] = batch * secs / (ms_c / 1e3)
    results["i_vqt_audio_s_per_s"] = batch * secs / (ms_v / 1e3)
    log(f"[serve] (i) CQT2010v2 {ms_c:.3f} ms = {batch * secs / (ms_c / 1e3):.1f} "
        f"audio-s/s; VQT gamma=2 {ms_v:.3f} ms = "
        f"{batch * secs / (ms_v / 1e3):.1f} audio-s/s; VQT(gamma=0) == CQT2010v2 "
        "bit for bit")
    del out_c, out_v, xg, x1

    # (j)-(l) one SGD step at 32 x 10 s in both modes: (j) the classifier's
    # train_step at the entry config and at bench's 2048/512/128-mel (its
    # labels), (k) the trainable STFT Magnitude and (l) the trainable
    # CQT1992v2 under bench's loss (bench.py:297-386). Under grad the
    # forward takes the pair (K5) once and no K1, K2 or K6; no waveform needs
    # a gradient, so no K3. The loss and every gradient are held against the
    # plain route on the card, the step is timed with CUDA events.
    from nnaudio_tpu_torch.models import train_step

    def sgd_step(loss_fn, params, lr=1e-3):
        """The SGD step of train_step for a loss of a params dict."""
        loss, grads = grads_of(lambda *v: loss_fn(dict(zip(params, v))),
                               list(params.values()))
        return loss, {k: v.detach() - lr * g for (k, v), g in zip(params.items(), grads)}

    def train_path(label, key, loss_fn, params, step, expect, audio_s, loss64=None):
        """Count one step, hold its loss and gradients against the plain
        route, time it; returns the step's ms. With ``loss64`` (the loss on
        fp64 inputs) and fp32 storage, the gradients are held against the
        plain route evaluated in fp64 instead: each within max(1e-4, 4x the
        fp32 plain route's own error against fp64), the rule of every
        tensor-core kernel's fp32 check (PERF.md section 2). Where ``d|X|``
        is ill-conditioned (``re/|X|`` at the near-zero bins of white noise)
        no fp32 route holds a fixed 1e-4 of the fp32 plain route, while the
        fp64 reference tells which route is closer. The loss stays held
        against the plain route."""
        (loss,), _, counts = counted(label, lambda: step()[0], (), expect)
        names = list(params)

        def loss_and_grads(fn=loss_fn, dtype=torch.float32):
            return grads_of(lambda *v: fn(dict(zip(names, v))),
                            [v.to(dtype) for v in params.values()])
        l_k, g_k = loss_and_grads()
        l_p, g_p = plain_path(loss_and_grads)
        mode = config.get_config().matmul_precision
        tol = TOL[mode]
        errs = {"loss": rel_err(l_k, l_p)}
        limits = {"loss": tol}
        fp64 = ""
        if loss64 is not None and mode == "highest":
            _, g_r = plain_path(lambda: loss_and_grads(loss64, torch.float64))
            for k, a, b, c in zip(names, g_k, g_p, g_r):
                errs[f"d{k} vs fp64"] = rel_err(a, c)
                limits[f"d{k} vs fp64"] = max(TOL["highest"], 4 * rel_err(b, c))
            fp64 = ("; gradients against the plain route in fp64: "
                    + ", ".join(f"d{k} kernel route {rel_err(a, c):.2e}, fp32 plain "
                                f"route {rel_err(b, c):.2e} (limit {limits[f'd{k} vs fp64']:.2e})"
                                for k, a, b, c in zip(names, g_k, g_p, g_r))
                    + "; against the fp32 plain route (printed): "
                    + ", ".join(f"d{k} {rel_err(a, b):.2e}" for k, a, b in zip(names, g_k, g_p)))
        else:
            for k, a, b in zip(names, g_k, g_p):
                errs[f"d{k}"], limits[f"d{k}"] = rel_err(a, b), tol
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        ms = cuda_ms(step, reps=10, warmup=2)
        log(f"[train] {label}: launches {counts}; vs plain route "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items() if "fp64" not in k)
            + f" (tol {tol:g}){fp64}; {ms:.3f} ms per step (CUDA events, median of 10) = "
            f"{audio_s / (ms / 1e3):.1f} audio-s/s")
        if any(errs[k] > limits[k] for k in errs) or not finite:
            fail(f"{label}: the kernel route's loss or gradients disagree with the plain route")
        results[f"{key}_audio_s_per_s"] = audio_s / (ms / 1e3)
        return ms

    gen = phase_gen("j-l")
    xj = {16000: randn(batch, 16000 * secs), sr_b: randn(batch, sr_b * secs)}
    labels = torch.as_tensor(np.random.RandomState(4).randint(0, 10, size=(batch,)),
                             device=dev)
    y_true = torch.as_tensor(np.random.RandomState(1).randn(batch, 8).astype(np.float32),
                             device=dev)
    one_pair = {"framed_pair": 1}
    stt = STFT(n_fft=2048, hop_length=512, output_format="Magnitude", trainable=True,
               verbose=False, device=dev)
    qt = CQT1992v2(sr=sr_b, hop_length=512, n_bins=84, bins_per_octave=12,
                   trainable=True, verbose=False, device=dev)

    def stft_loss(p, x=None, y=None):
        x = xj[sr_b] if x is None else x
        y = y_true if y is None else y
        spec = stt._forward(p, x, output_format="Magnitude")
        return ((spec.mean(dim=-1) @ p["head"] - y) ** 2).mean()

    def stft_loss64(p):
        # the magnitude's gradient re/|X| is ill-conditioned at the bins of
        # white noise where |X| is near 0: how far each route is from fp64
        return stft_loss(p, xj[sr_b].double(), y_true.double())

    def cqt_loss(p):
        spec = qt.apply(p, xj[sr_b], output_format="Magnitude",
                        normalization_type="librosa")
        return ((spec.mean(dim=-1) @ p["head"] - y_true) ** 2).mean()

    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for cfg, sr, n_fft, hop, n_mels in (("entry 1024/256/64", 16000, 1024, 256, 64),
                                            ("bench 2048/512/128", sr_b, 2048, 512, 128)):
            clf = SpectrogramClassifier(n_classes=10, sr=sr, n_fft=n_fft, hop_length=hop,
                                        n_mels=n_mels, seed=0, device=dev)
            params = clf.init_params
            x_clf = xj[sr]
            key = f"j_{cfg.split()[0]}_{mode}"
            train_path(f"(j) classifier train_step {cfg} {mode}", key,
                       lambda p, c=clf, x_=x_clf: c.loss_fn(p, x_, labels), params,
                       lambda c=clf, p_=params, x_=x_clf: train_step(c, p_, x_, labels),
                       one_pair, batch * secs)
            if mode == "highest":
                log_profile(f"j, {cfg}", lambda c=clf, p_=params, x_=x_clf:
                            train_step(c, p_, x_, labels))
            del clf, params
        params_k = {"wsin": stt.wsin, "wcos": stt.wcos,
                    "head": torch.full((1025, 8), 1e-3, device=dev)}
        train_path(f"(k) trainable STFT 2048/512 step {mode}", f"k_{mode}", stft_loss,
                   params_k, lambda: sgd_step(stft_loss, params_k), one_pair, batch * secs,
                   loss64=stft_loss64)
        params_l = {"cqt_kernels_real": qt.cqt_kernels_real,
                    "cqt_kernels_imag": qt.cqt_kernels_imag,
                    "head": torch.full((84, 8), 1e-3, device=dev)}
        train_path(f"(l) trainable CQT1992v2 step {mode}", f"l_{mode}", cqt_loss,
                   params_l, lambda: sgd_step(cqt_loss, params_l), one_pair, batch * secs)
        if mode == "highest":
            log_profile("k", lambda: sgd_step(stft_loss, params_k))
            log_profile("l", lambda: sgd_step(cqt_loss, params_l))
    config.set_matmul_precision("highest")

    # the input's gradient through a frozen STFT Magnitude at (b)'s shape:
    # K5 forward, K3 as dx; and a trainable iSTFT's step at (d)'s shape: K3
    # forward, the kernels' dW as matmuls (the spectrum needs no gradient)
    x_in = xj[sr_b]
    gen = phase_gen("b grad, d step")
    with torch.no_grad():
        g_b = torch.randn(st(x_in).shape, generator=gen, device=dev)
    train_path("(b) input gradient, frozen STFT Magnitude", "b_input_grad",
               lambda p: (st(p["x"]) * g_b).sum(), {"x": x_in},
               lambda: grads_of(lambda x_: (st(x_) * g_b).sum(), [x_in]),
               {"framed_pair": 1, "synthesis_ola": 1}, batch * secs)
    ist_t = iSTFT(n_fft=2048, hop_length=512, trainable_kernels=True,
                  trainable_window=True, verbose=False, device=dev)
    with torch.no_grad():
        X_d = stc(x_in)
    # a seeded target: against the input itself, which the layer
    # reconstructs, the loss and its gradients are rounding noise
    target = randn(*x_in.shape)

    def istft_loss(p):
        rec = ist_t.apply(p, X_d, onesided=True, length=x_in.shape[1])
        return ((rec - target) ** 2).mean()
    params_i = dict(ist_t.trainable_params())
    train_path("(d) trainable iSTFT 2048/512 step", "d_train", istft_loss, params_i,
               lambda: sgd_step(istft_loss, params_i), {"synthesis_ola": 1}, batch * secs)
    del X_d, g_b, xj, target

    # (m) Gammatonegram and ChromaSTFT at their defaults (22.05 kHz, 2048/512,
    # 64 bins and 12 chroma) on 32 x 10 s: one filterbank launch (K2) each;
    # then one SGD step of each with a trainable bank and STFT: the pair
    # (K5) once, no K1, K2 or K6
    gen = phase_gen("m")
    xm = randn(batch, sr_b * secs)
    frontends = {"Gammatonegram": (Gammatonegram(verbose=False, device=dev),
                                   Gammatonegram(trainable_bins=True, trainable_STFT=True,
                                                 verbose=False, device=dev),
                                   "gammatone_basis", 64),
                 "ChromaSTFT": (ChromaSTFT(verbose=False, device=dev),
                                ChromaSTFT(trainable_chroma=True, trainable_STFT=True,
                                           verbose=False, device=dev),
                                "chroma_basis", 12)}

    def bank_loss(layer):
        def loss(p):
            return ((layer.apply(p, xm).mean(dim=-1) @ p["head"] - y_true) ** 2).mean()
        return loss
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, (layer, layer_t, basis, rows) in frontends.items():
            with torch.no_grad():
                drive(f"(m) {label} {mode}", lambda: layer(xm), (batch, rows, 431),
                      expect={k2_route(mode): 1})
                ms = cuda_ms(lambda: layer(xm))
            results[f"m_{label}_{mode}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            log(f"[serve] (m) {label} {mode}: {batch} x {secs} s in {ms:.3f} ms = "
                f"{batch * secs / (ms / 1e3):.1f} audio-s/s")
            params_m = {basis: getattr(layer_t, basis), "wsin": layer_t.wsin,
                        "wcos": layer_t.wcos,
                        "head": torch.full((rows, 8), 1e-3, device=dev)}
            loss_m = bank_loss(layer_t)
            train_path(f"(m) trainable {label} step {mode}", f"m_{label}_train_{mode}",
                       loss_m, params_m, lambda: sgd_step(loss_m, params_m), one_pair,
                       batch * secs)
    config.set_matmul_precision("highest")
    del xm, frontends

    # (n) the pyramid inverses at INV_CFG on seeded in-band tones: the pair
    # (K5) once per octave for the Complex forward, one K3 for the collapsed
    # dual synthesis; the host build of each dual bank is timed apart (it is
    # cached for the calls after it); then CQT2010v2 with early downsampling
    # at hop 64, and one .inverse of CQT2010v2() at its defaults, for K3 at
    # the (84, 32386) bank (its hop 512 undersamples the top octave, so its
    # SNR is printed, not held)
    xt = inband_tones(batch, sr_b * secs, sr_b, 0, dev)
    early_cfg = {**INV_CFG, "hop_length": 64, "earlydownsample": True}
    inverses = [
        ("CQT2010v2", c2010_n, 40.0),
        ("VQT gamma=5", VQT(gamma=5.0, **INV_CFG, output_format="Complex",
                            verbose=False, device=dev), 40.0),
        ("CQT2010", CQT2010(**INV_CFG, output_format="Complex", verbose=False,
                            device=dev), 40.0),
        ("CQT2010v2 early downsample, hop 64",
         CQT2010v2(**early_cfg, output_format="Complex", verbose=False, device=dev), 35.0),
        ("CQT2010v2() defaults, hop 512", c2010_d, None),
    ]
    with torch.no_grad(), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*under-sampled.*")
        for label, layer, limit in inverses:
            # phase 3 built the default bank; build it again to time it
            layer._dual_cache.clear()
            t0 = time.perf_counter()
            kc, _, start, hop_top = layer._pyramid_dual_kernels("librosa", 1e-3)
            build_s = time.perf_counter() - t0

            def inv(layer=layer):
                return layer.inverse(layer(xt), length=xt.shape[1])
            (rec,), dt = drive(f"(n) {label} Complex -> inverse", inv, tuple(xt.shape),
                               tol=1e-3, expect={"framed_pair": layer.n_octaves,
                                                 "synthesis_ola": 1})
            snr = interior_snr_db(xt, rec)
            ms = cuda_ms(inv, reps=5, warmup=1)
            key = label.split()[0] + ("_early" if "early" in label else "")
            key += "_default" if limit is None else ""
            results[f"n_{key}_snr_db"] = snr
            results[f"n_{key}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            log(f"[path] (n) {label}: dual bank {tuple(kc.shape)}, synthesis hop "
                f"{hop_top}, offset {start}, built on the host in {build_s:.2f} s (the "
                f"first call only); interior SNR {snr:.1f} dB"
                + (f" (limit > {limit:g} dB)" if limit else " (not held: hop 512 "
                   "undersamples the top octave)"))
            log(f"[serve] (n) {label}: forward + inverse of {batch} x {secs} s in "
                f"{ms:.3f} ms = {batch * secs / (ms / 1e3):.1f} audio-s/s")
            if limit is not None and not snr > limit:
                fail(f"(n) {label}: SNR {snr} dB is not above {limit} dB")
            del rec

    # (o) GriffinLimCQT in the three families at INV_CFG, 32 iterations from a
    # seeded phase, on each family's magnitude of (n)'s tones: per iteration
    # one K3 and the re-analysis (the pair once for 1992v2, once per octave
    # for the pyramids), and one K3 more for the final synthesis
    n_iter = 32
    gen = phase_gen("o")
    gl_families = [
        ("1992v2", CQT1992v2(sr=sr_b, fmin=55, n_bins=48, bins_per_octave=12,
                             hop_length=128, verbose=False, device=dev), {}),
        ("2010v2", CQT2010v2(**INV_CFG, verbose=False, device=dev),
         dict(earlydownsample=False)),
        ("vqt", VQT(gamma=5.0, **INV_CFG, verbose=False, device=dev),
         dict(earlydownsample=False, gamma=5.0)),
    ]
    with torch.no_grad():
        for family, mag_layer, extra in gl_families:
            gl_cqt = GriffinLimCQT(sr=sr_b, fmin=55, n_bins=48, bins_per_octave=12,
                                   hop_length=128, family=family, n_iter=n_iter,
                                   verbose=False, device=dev, **extra)
            S = mag_layer(xt)
            phase = torch.randn(S.shape, generator=gen, device=dev)

            def recover(gl_cqt=gl_cqt, S=S, phase=phase):
                return gl_cqt(S, rand_phase=phase, length=xt.shape[1])
            per = 1 if family == "1992v2" else gl_cqt._cqt.n_octaves
            label = f"(o) GriffinLimCQT {family}, {n_iter} iterations"
            (audio,), dt, counts = counted(label, recover, tuple(xt.shape),
                                           {"framed_pair": n_iter * per,
                                            "synthesis_ola": n_iter + 1})
            sc = spectral_convergence(mag_layer, audio, S)
            sc_plain = spectral_convergence(mag_layer, plain_path(recover), S)
            ms = cuda_ms(recover, reps=3, warmup=1)
            results[f"o_{family}_spectral_convergence"] = sc
            results[f"o_{family}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            log(f"[path] {label}: {dt * 1e3:.1f} ms, launches {counts}; spectral "
                f"convergence {sc:.4f}, plain path {sc_plain:.4f} (|diff| tol "
                f"{SC_DELTA}, ceiling {SC_CQT_CEILING})")
            log(f"[serve] (o) {family}: {batch} x {secs} s in {ms:.3f} ms (CUDA events, "
                f"median of 3) = {batch * secs / (ms / 1e3):.1f} audio-s/s")
            if abs(sc - sc_plain) > SC_DELTA or sc > SC_CQT_CEILING:
                fail(f"{label}: spectral convergence {sc} (plain {sc_plain})")
            log_profile(f"o, {family}", recover)
            del audio, S, phase, gl_cqt
    del xt, gl_families, inverses

    # (p) the pyramid switches at (i)'s CQT2010v2() and VQT(gamma=2), each on
    # alone: the outputs against the serial loop, and CUDA-event times of
    # both ([ab] lines; serial, switch, serial). The defaults stay off.
    gen = phase_gen("p")
    xp_ = randn(batch, sr_b * secs)
    with torch.no_grad():
        for label, layer in (("CQT2010v2()", c2010), ("VQT(gamma=2)", vqt2)):
            ref = layer(xp_)
            for switch, setter, pairs in (
                    ("use_parallel_chain", config.set_use_parallel_chain, layer.n_octaves),
                    ("use_fused_pyramid", config.set_use_fused_pyramid, 0)):
                ms_a = cuda_ms(lambda: layer(xp_))
                setter(True)
                try:
                    (out,), _, counts = counted(
                        f"(p) {label} {switch}=True", lambda: layer(xp_),
                        (batch, 84, 431), {"framed_pair": pairs} if pairs else {})
                    ms_on = cuda_ms(lambda: layer(xp_))
                finally:
                    setter(None)
                ms_b = cuda_ms(lambda: layer(xp_))
                err = rel_err(out, ref)
                ms_serial = (ms_a + ms_b) / 2
                key = f"p_{label.split('(')[0]}_{switch}"
                results[f"{key}_ms"], results[f"{key}_serial_ms"] = ms_on, ms_serial
                log(f"[ab] (p) {label} {switch}=True: {ms_on:.3f} ms against the serial "
                    f"loop's {ms_a:.3f} / {ms_b:.3f} ms (before / after) = "
                    f"{ms_serial / ms_on:.2f}x; launches {counts}; max err vs the serial "
                    f"loop {err:.2e} of max|ref| (tol {SWITCH_TOL:g})")
                if err > SWITCH_TOL:
                    fail(f"(p) {label} {switch}: output differs from the serial loop")
                del out
            del ref
    del xp_

    # (q) CFP(fs=16000) and Combined_Frequency_Periodicity() on 32 x 10 s at
    # 16 kHz: no kernel of the port (cuFFT and matmuls); against a numpy fp64
    # oracle on one clip (tests/test_cfp.py:75), and use_mxu_fft=True against
    # the default path (tests/test_mxu_fft.py:75)
    gen = phase_gen("q")
    xq = randn(batch, 16000 * secs)
    cfp = CFP(fs=16000, device=dev)
    cfp_full = Combined_Frequency_Periodicity(device=dev)
    x1s = np.random.RandomState(2).randn(16000).astype(np.float32)
    with torch.no_grad():
        z1 = cfp(x1s[None]).cpu().numpy()[0]
        z_ref = cfp_oracle(x1s, filters)
        ok = z1.shape == z_ref.shape and np.allclose(z1, z_ref, rtol=1e-2, atol=1e-4)
        log(f"[oracle] CFP Z on one 1 s clip vs numpy fp64: max abs err "
            f"{float(np.abs(z1 - z_ref).max()):.2e} (rtol 1e-2, atol 1e-4) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("CFP disagrees with the numpy fp64 oracle")
        n_log = cfp.freq2logfreq_matrix.shape[0]
        t_q = xq.shape[1] // cfp.hop_length + 1
        for label, layer, fn, shape in (
                ("CFP", cfp, lambda: cfp(xq), (batch, n_log, t_q)),
                ("Combined_Frequency_Periodicity", cfp_full,
                 lambda: list(cfp_full(xq)), (batch, n_log, t_q - 2))):
            outs, dt, _ = counted(f"(q) {label}", fn, shape, {})
            ms = cuda_ms(fn, reps=5, warmup=1)
            config.set_use_mxu_fft(True)
            try:
                fast = fn()
                ms_mxu = cuda_ms(fn, reps=5, warmup=1)
            finally:
                config.set_use_mxu_fft(None)
            fast = fast if isinstance(fast, list) else [fast]
            err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
                      for a, b in zip(fast, outs))
            results[f"q_{label}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            log(f"[ab] (q) {label} use_mxu_fft=True: {ms_mxu:.3f} ms against "
                f"torch.fft.rfft's {ms:.3f} ms = {ms / ms_mxu:.2f}x; max err "
                f"{err:.2e} of max(|ref|, 1) (tol 3e-4)")
            log(f"[serve] (q) {label}: {batch} x {secs} s at 16 kHz in {ms:.3f} ms = "
                f"{batch * secs / (ms / 1e3):.1f} audio-s/s")
            if err > 3e-4:
                fail(f"(q) {label}: use_mxu_fft disagrees with the default path")
            log_profile(f"q, {label}", fn)
            del outs, fast
    del xq, cfp, cfp_full

    # (r) on a seeded harmonic batch: TimeStretch(1024, 256) at rates 0.8 and
    # 1.25 and PitchShift(n_steps=7) (the pair, K5, once; the synthesis, K3,
    # once; the phase-locked vocoder between them is a loop over output steps
    # issued by the host), and resample 22050 -> 16000 against scipy. The
    # kernels are held stage by stage against their plain versions on the
    # path's inputs: the STFT's Complex output (K5), then the iSTFT (K3) of
    # the vocoder's output. The vocoder runs the same PyTorch code on both
    # paths and magnifies the 1e-6 between their STFTs: the locked vocoder's
    # peak picking is discontinuous, atan2 is ill-conditioned at bins near
    # 0, and its fp32 phases reach ~1e5 rad, where one ulp is ~1e-2 rad. So
    # the waveforms of the two paths are printed, not held. Held end to end:
    # the output's STFT magnitude, which a phase offset common to
    # overlapping frames leaves alone, against the plain path's by spectral
    # convergence, limit SC_TOL (10x the kernels' 1e-4). The witness: on one
    # clip, the vocoder in fp64 on both paths' STFTs beside its fp32 run, so
    # the part of the difference that fp32 rounding makes shows apart
    from scipy import signal as sps

    SC_TOL = 1e-3
    mag_r = STFT(n_fft=1024, hop_length=256, output_format="Magnitude",
                 verbose=False, device=dev)

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    xr = harmonic_batch(batch, sr_b * secs, sr_b, 1, dev)
    ts = TimeStretch(n_fft=1024, hop_length=256, device=dev)
    ps = PitchShift(sr=sr_b, n_fft=1024, hop_length=256, device=dev)
    shift = 2.0 ** (-7 / 12)  # PitchShift(7)'s stretch rate
    stretch = {"TimeStretch rate 0.8": 0.8, "TimeStretch rate 1.25": 1.25,
               "PitchShift n_steps=7": shift}
    with torch.no_grad():
        X_k = ts._stft(xr)
        X_p = plain_path(lambda: ts._stft(xr))
        e5 = rel_err(X_k, X_p)
        for label, fn, shape, expect in (
                ("TimeStretch rate 0.8", lambda: ts(xr, rate=0.8),
                 (batch, round(xr.shape[1] / 0.8)), {"framed_pair": 1, "synthesis_ola_fft": 1}),
                ("TimeStretch rate 1.25", lambda: ts(xr, rate=1.25),
                 (batch, round(xr.shape[1] / 1.25)), {"framed_pair": 1, "synthesis_ola_fft": 1}),
                ("PitchShift n_steps=7", lambda: ps(xr, n_steps=7), tuple(xr.shape),
                 {"framed_pair": 1, "synthesis_ola_fft": 1}),
                ("resample 22050 -> 16000", lambda: resample(xr, sr_b, 16000),
                 (batch, 160000), {})):
            (y,), dt, counts = counted(f"(r) {label}", fn, shape, expect)
            ref = plain_path(fn)
            l2 = rel_l2(y, ref)
            ms = cuda_ms(fn, reps=3, warmup=1)
            key = label.split()[0] + "_" + label.split()[-1]
            results[f"r_{key}_audio_s_per_s"] = batch * secs / (ms / 1e3)
            stage = ""
            if label in stretch:
                rate = stretch[label]
                Y = phase_vocoder(X_k, rate, ts.hop)
                length = int(round(xr.shape[1] / rate))
                e3 = rel_err(ts._istft(Y, onesided=True, length=length),
                             plain_path(lambda: ts._istft(Y, onesided=True, length=length)))
                sc = rel_l2(*(plain_path(lambda: mag_r(a)) for a in (y, ref)))
                one = (X_k[:1], X_p[:1])
                v32 = [phase_vocoder(a, rate, ts.hop) for a in one]
                v64 = [phase_vocoder(a.double(), rate, ts.hop) for a in one]
                stage = (f"; stages against their plain versions: the STFT's Complex "
                         f"output (K5) {e5:.2e}, the iSTFT of the vocoder's output (K3) "
                         f"{e3:.2e} (tol {TOL['highest']:g}); the output's STFT "
                         f"magnitude by spectral convergence {sc:.3e} (tol {SC_TOL:g}); "
                         f"witness, one clip: the vocoder on the two paths' STFTs "
                         f"differs by {rel_l2(*v32):.3e} relative L2 in fp32, "
                         f"{rel_l2(*v64):.3e} in fp64, its fp32 run from its fp64 run "
                         f"{rel_l2(v32[1].double(), v64[1]):.3e}")
                if max(e5, e3) > TOL["highest"]:
                    fail(f"(r) {label}: a kernel stage disagrees with its plain version")
                if sc > SC_TOL:
                    fail(f"(r) {label}: the output's STFT magnitude disagrees with "
                         "the plain path's")
                del Y, v32, v64
            held = ("held at 1e-6: no kernel" if label.startswith("resample") else
                    "printed, not held: the vocoder magnifies its input's "
                    "differences; held by the magnitude above")
            log(f"[path] (r) {label}: {dt * 1e3:.1f} ms, launches {counts}{stage}; "
                f"end to end against the plain path {l2:.2e} relative L2 ({held})")
            log(f"[serve] (r) {label}: {batch} x {secs} s in {ms:.3f} ms (CUDA events, "
                f"median of 3) = {batch * secs / (ms / 1e3):.1f} audio-s/s")
            if label.startswith("resample"):
                if l2 > 1e-6:
                    fail("(r) resample differs between the kernel and the plain path")
                want = sps.resample_poly(xr[0].double().cpu().numpy(), 320, 441,
                                         window=("kaiser", 5.0))
                e = float(np.abs(y[0].cpu().numpy() - want).max() / np.abs(want).max())
                log(f"[oracle] (r) resample 22050 -> 16000, one clip, vs "
                    f"scipy.signal.resample_poly: {e:.2e} of max|ref| (tol 2e-6)")
                if e > 2e-6:
                    fail("(r) resample disagrees with scipy.signal.resample_poly")
            del y, ref
        del X_k, X_p
    del xr, ts, ps, mag_r

    # (s) streaming at full width: 32 streams x 10 s at 22.05 kHz fed in
    # 2048-sample chunks (107 steps), in fp32 and bf16 storage. Each stream is
    # held against its offline center=False transform on the card
    # (tests/test_streaming.py's tolerances in fp32, the fast-mode 5e-2 in
    # bf16), each primed step must launch its kernel once and a priming step
    # none, and the same stream with fuse=False launches nothing and gives
    # the same frames. Printed: ms per step at B=32 and B=1 (CUDA events
    # around the step, the host included), audio-s/s, whether the frames are
    # the offline ones bit for bit, and the idle share of 20 steps under
    # torch.profiler. Then each kernel at the shapes a step gives it (T=4:
    # a 2048-sample chunk; T=1: a chunk of one hop), against its plain
    # version and timed, in both modes
    from nnaudio_tpu_torch import streaming
    from nnaudio_tpu_torch.features import MFCC

    gen = phase_gen("s")
    chunk = 2048
    steps_s = sr_b * secs // chunk
    xs_noise = randn(batch, steps_s * chunk)
    xs_harm = harmonic_batch(batch, steps_s * chunk, sr_b, 2, dev)
    xs_tones = inband_tones(batch, steps_s * chunk, sr_b, 2, dev)
    h_cfg = dict(sr=sr_b, fmin=55, n_bins=48, hop_length=128)
    # (rtol, atol of max |ref|) against the offline transform in fp32
    # (tests/test_streaming.py:47-364); bf16 storage: the fast-mode 5e-2
    s_tol = {"stft": (0.0, 1e-5), "bank": (1e-4, 1e-5), "mfcc": (1e-4, 1e-4), "cqt": (0.0, 1e-5)}

    def analysis_feed(x):
        return [x[:, i * chunk:(i + 1) * chunk] for i in range(steps_s)]

    def run_stream(s, feed, axis, flush=False):
        """Every step of a stream over ``feed``: (output, launches of each
        step, the last state)."""
        state = s.init_state(feed[0].shape[0])
        outs, per_step = [], []
        for piece in feed:
            before = dict(fk.LAUNCHES)
            state, out = s.step(state, piece)
            per_step.append({k: v - before[k] for k, v in fk.LAUNCHES.items() if v != before[k]})
            if out.shape[axis]:
                outs.append(out)
        if flush:
            outs.append(s.flush(state))
        return torch.cat(outs, dim=axis), per_step, state

    def one_stream(state):
        """The first stream's part of a state."""
        if isinstance(state, streaming.StreamState):
            return streaming.StreamState(state.buffer[:1], state.primed)
        if isinstance(state, tuple):
            return (state[0][:1], state[1])
        return state[:1]

    # the synthesis streams' inputs: the analysis streams' Complex frames
    with torch.no_grad():
        st_frames = list(streaming.StreamingSTFT(2048, 512, output_format="Complex",
                                                 device=dev).stream(xs_harm, chunk))
        cq_frames = list(streaming.StreamingCQT(output_format="Complex", device=dev,
                                                **h_cfg).stream(xs_tones, chunk))
    off_cqt_h = CQT1992v2(center=False, output_format="Complex", verbose=False, device=dev,
                          **h_cfg)
    stream_specs = [
        # (label, make(fuse), kernel, feed, output axis, offline, tolerance key)
        ("StreamingSTFT Magnitude",
         lambda fuse: streaming.StreamingSTFT(2048, 512, fuse=fuse, device=dev),
         "framed_magnitude", analysis_feed(xs_noise), 2,
         lambda: STFT(2048, hop_length=512, center=False, output_format="Magnitude",
                      verbose=False, device=dev)(xs_noise), "stft"),
        ("StreamingSTFT Complex",
         lambda fuse: streaming.StreamingSTFT(2048, 512, output_format="Complex", fuse=fuse,
                                              device=dev),
         "framed_pair", analysis_feed(xs_noise), 2,
         lambda: STFT(2048, hop_length=512, center=False, output_format="Complex",
                      verbose=False, device=dev)(xs_noise), "stft"),
        ("StreamingMel 128, power 2",
         lambda fuse: streaming.StreamingMel(n_mels=128, fuse=fuse, device=dev),
         "framed_filterbank", analysis_feed(xs_noise), 2,
         lambda: MelSpectrogram(n_mels=128, center=False, verbose=False, device=dev)(xs_noise),
         "bank"),
        ("StreamingMel 128, power 1",
         lambda fuse: streaming.StreamingMel(n_mels=128, power=1.0, fuse=fuse, device=dev),
         "framed_magnitude", analysis_feed(xs_noise), 2,
         lambda: MelSpectrogram(n_mels=128, power=1.0, center=False, verbose=False,
                                device=dev)(xs_noise), "bank"),
        ("StreamingMFCC", lambda fuse: streaming.StreamingMFCC(fuse=fuse, device=dev),
         "framed_filterbank", analysis_feed(xs_noise), 2,
         lambda: MFCC(top_db=None, center=False, verbose=False, device=dev)(xs_noise), "mfcc"),
        ("StreamingGammatone", lambda fuse: streaming.StreamingGammatone(fuse=fuse, device=dev),
         "framed_filterbank", analysis_feed(xs_noise), 2,
         lambda: Gammatonegram(center=False, verbose=False, device=dev)(xs_noise), "bank"),
        ("StreamingChroma", lambda fuse: streaming.StreamingChroma(fuse=fuse, device=dev),
         "framed_filterbank", analysis_feed(xs_noise), 2,
         lambda: ChromaSTFT(center=False, verbose=False, device=dev)(xs_noise), "bank"),
        ("StreamingCQT() Magnitude", lambda fuse: streaming.StreamingCQT(fuse=fuse, device=dev),
         "framed_magnitude_kchunk", analysis_feed(xs_noise), 2,
         lambda: CQT1992v2(center=False, verbose=False, device=dev)(xs_noise), "cqt"),
        ("StreamingCQT() Complex",
         lambda fuse: streaming.StreamingCQT(output_format="Complex", fuse=fuse, device=dev),
         "framed_pair", analysis_feed(xs_noise), 2,
         lambda: CQT1992v2(center=False, output_format="Complex", verbose=False,
                           device=dev)(xs_noise), "cqt"),
        ("StreamingiSTFT 2048/512",
         lambda fuse: streaming.StreamingiSTFT(2048, 512, fuse=fuse, device=dev),
         "synthesis_ola_fft", st_frames, 1,
         lambda: iSTFT(2048, hop_length=512, center=False, verbose=False, device=dev)(
             torch.cat(st_frames, dim=2), onesided=True), "istft"),
        ("StreamingInverseCQT (h)",
         lambda fuse: streaming.StreamingInverseCQT(fuse=fuse, device=dev, **h_cfg),
         "synthesis_ola", cq_frames, 1,
         lambda: off_cqt_h.inverse(torch.cat(cq_frames, dim=2)), "cqt"),
    ]
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        for label, make, kernel, feed, axis, offline, tol_key in stream_specs:
            if kernel == "framed_filterbank":
                kernel = k2_route(mode)
            elif kernel == "synthesis_ola_fft":
                kernel = k3_route(mode)
            s = make(None)
            synthesis = axis == 1
            with torch.no_grad():
                fk.reset_launches()
                got, per_step, state = run_stream(s, feed, axis, flush=synthesis)
                torch.cuda.synchronize()
                for k, v in fk.LAUNCHES.items():
                    launches[k] += v
                ref = offline()
                plain_s, plain_steps, _ = run_stream(make(False), feed, axis, flush=synthesis)
            if tuple(got.shape) != tuple(ref.shape) or not torch.isfinite(got).all():
                fail(f"(s) {label} {mode}: shape {tuple(got.shape)} (offline "
                     f"{tuple(ref.shape)}) or non-finite output")
            # a step emits once `width` samples have arrived
            primed = [i for i in range(len(feed))
                      if synthesis or (i + 1) * chunk >= s.width]
            bad = [i for i, c in enumerate(per_step)
                   if c != ({kernel: 1} if i in primed else {})]
            if bad or any(plain_steps):
                fail(f"(s) {label} {mode}: launches per step {per_step[:12]} (plain "
                     f"stream {[c for c in plain_steps if c][:3]}); expected one {kernel} "
                     "per primed step, none while priming")
            scale = float(ref.abs().max())
            diff = (got - ref).abs()
            err = edge = float(diff.max()) / scale
            if tol_key == "istft":
                err = float(diff[:, 2048:-2048].max()) / scale
                ok = err <= 1e-5 and edge <= 2e-3
                tol_txt = "interior 1e-05, edges 2e-03 of max|ref|"
            else:
                rtol, atol = s_tol[tol_key]
                ok = bool((diff <= atol * scale + rtol * ref.abs()).all())
                tol_txt = f"rtol {rtol:g}, atol {atol:g} of max|ref|"
            if mode == "default":
                ok = edge <= TOL["default"]
                tol_txt = f"{TOL['default']:g} of max|ref| in bf16 storage"
            # kernel against plain stream; the iSTFT's edges divide by a
            # window envelope near 0, which magnifies any two routes' last
            # bits there: held on the interior, as against the offline one
            e_plain = e_plain_all = rel_err(got, plain_s)
            if tol_key == "istft":
                e_plain = rel_err(got[:, 2048:-2048], plain_s[:, 2048:-2048])
            ok = ok and e_plain <= TOL[mode]
            same = torch.equal(got, ref)
            # one steady step from the last state, at B=32 and B=1
            piece = feed[-1]
            with torch.no_grad():
                ms32 = cuda_ms(lambda: s.step(state, piece))
                ms1 = cuda_ms(lambda: s.step(one_stream(state), piece[:1]))
                wall, kern = profile_path(lambda: [s.step(state, piece) for _ in range(20)])
            busy = sum(k_ms for k_ms, _ in kern.values())
            per_s = batch * chunk / sr_b / (ms32 / 1e3)
            key = f"s_{label}_{mode}"
            results[f"{key}_ms_per_step"], results[f"{key}_audio_s_per_s"] = ms32, per_s
            results[f"{key}_ms_per_step_b1"] = ms1
            results[f"{key}_idle_share"] = 1 - busy / wall if kern else None
            results[f"{key}_bit_equal_offline"] = same
            log(f"[stream] (s) {mode:8s} {label}: {len(feed)} steps, {kernel} x1 on each of "
                f"{len(primed)} primed steps, none on {len(feed) - len(primed)} priming; vs "
                f"offline center=False {err:.2e}"
                + (f" (edges {edge:.2e})" if tol_key == "istft" else "")
                + f" ({tol_txt}), bit-equal offline: {'yes' if same else 'no'}; fuse=False: "
                f"no launch, vs the kernel stream {e_plain:.2e}"
                + (f" on the interior ({e_plain_all:.2e} with the edges)"
                   if tol_key == "istft" else "")
                + f" (tol {TOL[mode]:g}) {'ok' if ok else 'FAIL'}")
            log(f"[serve] (s) {mode:8s} {label}: {ms32:.3f} ms per step at B={batch} "
                f"(CUDA events, median of {REPS}) = {per_s:.1f} audio-s/s; {ms1:.3f} ms at B=1; "
                f"20 steps under torch.profiler: wall {wall:.2f} ms, "
                + (f"device busy {busy:.2f} ms, idle {100 * (1 - busy / wall):.1f}%"
                   if kern else "device time not measured (no CUDA events)"))
            if not ok:
                fail(f"(s) {label} {mode}: the stream disagrees with the offline transform "
                     "or with its plain stream")
            del got, ref, plain_s, state
    config.set_matmul_precision("highest")

    # each kernel at the shapes a step gives it (T=4: a 2048-sample chunk,
    # T=1: a chunk of one hop; the inverse CQT's hop 128 gives T=16 and 4),
    # against its plain version and timed (host queued ahead), in both modes
    s_istft = streaming.StreamingiSTFT(2048, 512, device=dev)
    s_icqt = streaming.StreamingInverseCQT(device=dev, **h_cfg)
    fb_s = MelSpectrogram(n_mels=128, verbose=False, device=dev).mel_basis
    wc_s, ws_s = fourier(2048)
    f1, n1 = wc_s.shape
    nnz_s = int((fb_s != 0).sum())
    s_rows = {}
    for mode in ("highest", "default"):
        config.set_matmul_precision(mode)
        esz = 2 if mode == "default" else 4
        peak = PEAK_BF16 if mode == "default" else PEAK_TF32
        nnz6 = int(((wc_cqt.to(config.storage_dtype()) != 0)
                    | (ws_cqt.to(config.storage_dtype()) != 0)).sum())
        for t_s in (4, 1):
            x1k = randn(batch, (t_s - 1) * 512 + 2048)
            x6k = randn(batch, (t_s - 1) * 512 + n_cqt)
            cases_s = [
                ("K1 framed_magnitude", lambda: fk.framed_magnitude(x1k, wc_s, ws_s, 512),
                 lambda: fk.framed_magnitude_plain(x1k, wc_s, ws_s, 512),
                 4 * batch * t_s * f1 * n1,
                 esz * (x1k.numel() + 2 * f1 * n1) + 4 * batch * f1 * t_s,
                 f"B={batch} T={t_s} F={f1} N={n1} hop=512", t_s),
                ("K5 framed_pair", lambda: fk.framed_pair(x1k, wc_s, ws_s, 512),
                 lambda: fk.framed_pair_plain(x1k, wc_s, ws_s, 512),
                 4 * batch * t_s * f1 * n1,
                 esz * (x1k.numel() + 2 * f1 * n1) + 8 * batch * f1 * t_s,
                 f"B={batch} T={t_s} F={f1} N={n1} hop=512", t_s),
                ("K2 framed_filterbank",
                 lambda: dense_k2(x1k, wc_s, ws_s, fb_s, 512),
                 lambda: fk.framed_filterbank_plain(x1k, wc_s, ws_s, fb_s, 512),
                 4 * batch * t_s * f1 * n1 + 2 * batch * t_s * f1 * 128,
                 esz * (x1k.numel() + 2 * f1 * n1 + 128 * f1) + 4 * batch * 128 * t_s,
                 f"B={batch} T={t_s} F={f1} N={n1} M=128 hop=512", t_s),

                ("K6 framed_magnitude_kchunk",
                 lambda: fk.framed_magnitude_kchunk(x6k, wc_cqt, ws_cqt, 512),
                 lambda: fk.framed_magnitude_plain(x6k, wc_cqt, ws_cqt, 512),
                 4 * batch * t_s * nnz6,
                 esz * (x6k.numel() + 2 * wc_cqt.numel()) + 4 * batch * 84 * t_s,
                 f"B={batch} T={t_s} F=84 N={n_cqt} hop=512 "
                 f"splits={fk.kchunk_plan(batch, t_s, n_cqt)}", t_s),
            ]
            if mode == "highest":  # K2's FFT route: fp32 storage only
                cases_s.append((  # an STFT's own bases, a Mel's own filterbank
                    "K2 FFT route",
                    lambda: fk.framed_filterbank(x1k, wc_s, ws_s, fb_s, 512),
                    lambda: fk.framed_filterbank_plain(x1k, wc_s, ws_s, fb_s, 512),
                    batch * t_s * fft_frame_flops(n1, nnz_s),
                    4 * (x1k.numel() + batch * 128 * t_s),
                    f"B={batch} T={t_s} F={f1} N={n1} M=128 hop=512", t_s))
            for syn, hop_k, name_k in ((s_istft, 512, "iSTFT"), (s_icqt, 128, "inverse CQT (h)")):
                t_k = t_s if hop_k == 512 else 4 * t_s
                f3, n3 = syn._kc.shape
                # copies, which record no factors: dense K3 on either stream's kernels
                args = (randn(batch, f3, t_k), randn(batch, f3, t_k), syn._kc.clone(),
                        syn._ks.clone(), hop_k)
                cases_s.append((
                    f"K3 synthesis_ola ({name_k})",
                    lambda a=args: fk.synthesis_ola(*a),
                    lambda a=args: fk.synthesis_ola_plain(*a),
                    4 * batch * t_k * f3 * n3,
                    esz * (2 * batch * f3 * t_k + 2 * f3 * n3)
                    + 4 * batch * (n3 + hop_k * (t_k - 1)),
                    f"B={batch} T={t_k} F={f3} N={n3} hop={hop_k}", t_k))
            for label, kern_fn, plain_fn, flops, nbytes, shape, t_k in cases_s:
                with torch.no_grad():
                    got, want = kern_fn(), plain_fn()
                    torch.cuda.synchronize()
                    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
                    err = max(rel_err(g, w) for g, w in pairs)
                    ms_k = cuda_ms(kern_fn, queue_ahead=True)
                    ms_p = cuda_ms(plain_fn, queue_ahead=True)
                t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
                bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
                s_rows[f"{label} T={t_k} {mode}"] = dict(
                    ms=ms_k, plain_ms=ms_p, bound_ms=bound, bound_by=by, max_rel_err=err)
                log(f"[time] (s) {mode:8s} {label} at a step's shape {shape}: kernel "
                    f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bound:.4f} ms ({by}), "
                    f"roofline share {100 * bound / ms_k:.1f}%; vs plain {err:.2e} (tol "
                    f"{TOL[mode]:g}) {'ok' if err <= TOL[mode] else 'FAIL'}")
                if err > TOL[mode]:
                    fail(f"(s) {label} T={t_k} {mode}: the kernel disagrees with its plain version")
                del got, want
    config.set_matmul_precision("highest")
    results["s_kernel_rows"] = s_rows
    del xs_noise, xs_harm, xs_tones, st_frames, cq_frames, stream_specs

    # (t) parallel at world size 1: an NCCL process group of one and a (1, 1)
    # mesh. Each wrapper is held against the single-device call on the same
    # inputs (exact, or within 1e-6 of max |ref| where it reorders a sum or
    # adds an all_reduce), with the same launches. Across ranks (2 and 4) the
    # package is held only on the CPU, with gloo: this machine has one card
    import socket

    import torch.distributed as dist
    from nnaudio_tpu_torch import parallel
    from nnaudio_tpu_torch.core.overlap import extend_fbins

    gen = phase_gen("t")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    parallel.distributed_initialize(backend="nccl", init_method=f"tcp://localhost:{port}",
                                    world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh()
        xt_ = randn(batch, 430 * 512)
        x16 = randn(batch, 16000 * secs)
        tones = inband_tones(batch, sr_b * secs, sr_b, 3, dev)
        st_t = STFT(n_fft=2048, hop_length=512, output_format="Magnitude", verbose=False,
                    device=dev)
        stc_t = STFT(n_fft=2048, hop_length=512, center=False, output_format="Complex",
                     verbose=False, device=dev)
        ist_full = iSTFT(n_fft=2048, hop_length=512, center=False, verbose=False, device=dev)
        c1992_t = CQT1992(sr=16000, fmin=220, n_bins=40, hop_length=256, trainable_CQT=True,
                          device=dev)
        with torch.no_grad():
            X_h = cqt_h(tones)
            real_t, imag_t = parallel.time_sharded_stft(xt_, stc_t.wcos, stc_t.wsin, 512, mesh)
            spec_t = extend_fbins(torch.stack((real_t, -imag_t), dim=-1))

        def stft_pair():
            X = stc_t(F.pad(xt_, (0, 1536)))
            return [X[..., 0], -X[..., 1]]
        t_cases = [
            # (label, sharded, single device, tolerance of max |ref|: 0 = exact)
            ("data_parallel STFT Magnitude 2048/512",
             lambda: parallel.data_parallel(st_t, mesh, output_format="Magnitude")(
                 parallel.shard_batch(xt_, mesh)), lambda: st_t(xt_), 0.0),
            ("bank_sharded_apply CQT1992v2()",
             lambda: parallel.bank_sharded_apply(cqt, mesh)(parallel.shard_batch(xt_, mesh)),
             lambda: cqt(xt_), 0.0),
            ("contraction_sharded_cqt1992 (K5 + all_reduce)",
             lambda: parallel.contraction_sharded_cqt1992(c1992_t, mesh)(x16),
             lambda: c1992_t(x16, output_format="Magnitude"), 1e-6),
            ("bank_sharded_inverse (h) (K3 + all_reduce)",
             lambda: parallel.bank.bank_sharded_inverse(cqt_h, mesh)(X_h),
             lambda: cqt_h.inverse(X_h), 1e-6),
            ("time_sharded_stft 2048/512",
             lambda: list(parallel.time_sharded_stft(xt_, stc_t.wcos, stc_t.wsin, 512, mesh)),
             stft_pair, 0.0),
            ("time_sharded_istft 2048/512 (interior)",
             lambda: parallel.time_sharded_istft(
                 spec_t[..., 0], spec_t[..., 1], ist_full.kernel_cos, ist_full.kernel_sin,
                 ist_full.window_mask, 512, mesh)[:, 2048:-2048],
             lambda: ist_full(spec_t, onesided=False)[:, 2048:xt_.shape[1] - 2048], 1e-6),
        ]
        with torch.no_grad():
            for label, sharded, single, tol in t_cases:
                ref = single()
                refs = ref if isinstance(ref, list) else [ref]
                (out, *rest), _, counts = counted(f"(t) {label}", sharded,
                                                  tuple(refs[0].shape))
                _, _, counts_1 = counted(f"(t) {label}, single device", single,
                                         tuple(refs[0].shape))
                outs = [out, *rest]
                err = max(rel_err(o, r) for o, r in zip(outs, refs))
                same = all(torch.equal(o, r) for o, r in zip(outs, refs))
                ok = (same if tol == 0 else err <= tol) and counts == counts_1
                log(f"[path] (t) {label}, world size 1, mesh (1, 1): vs the single-device "
                    f"call {err:.2e} of max|ref| ({'exact' if tol == 0 else f'tol {tol:g}'}"
                    f"; bit-equal: {'yes' if same else 'no'}), launches {counts} (single "
                    f"device {counts_1}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"(t) {label}: differs from the single-device call")
                del ref, refs, outs
        log("[path] (t) behaviour across ranks (2 and 4 gloo processes: the halo ring, "
            "the all_reduce of partial products, gradients summed over `data`, a "
            "checkpoint restored onto another mesh) is held only on the CPU, by "
            "tests/test_torch_parallel.py: this machine has one card")
    finally:
        dist.destroy_process_group()
    del xt_, x16, tones, X_h, spec_t

    # (u) utils on the card: the state of a trained MelSpectrogram (one SGD
    # step of a trainable bank and STFT) saved and restored in both formats,
    # bit for bit; and profiling.trace around one (b) call, whose trace must
    # name K1's kernel
    import tempfile

    from nnaudio_tpu_torch import utils

    gen = phase_gen("u")
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_u_"))

    def trainable_mel():
        return MelSpectrogram(sr=sr_b, n_fft=2048, hop_length=512, n_mels=128,
                              trainable_mel=True, trainable_STFT=True, verbose=False, device=dev)
    mel_u = trainable_mel()
    xu = randn(batch, sr_b * secs)
    trained = mel_u.trainable_params()
    loss_u = torch.log1p(mel_u(xu)).mean()
    grads_u = torch.autograd.grad(loss_u, list(trained.values()))
    mel_u.update_params({k: v.detach() - 1e-2 * g for (k, v), g in zip(trained.items(), grads_u)})
    state_u = mel_u.state_dict()
    for suffix in (".npz", ".pt"):
        path = out_dir / f"trained_mel{suffix}"
        utils.save_params(str(path), state_u)
        fresh = trainable_mel()
        utils.restore_transform(fresh, str(path))
        same = all(torch.equal(fresh.state_dict()[k], v) for k, v in state_u.items())
        with torch.no_grad():
            same = same and torch.equal(fresh(xu), mel_u(xu))
        log(f"[path] (u) save_params / restore_transform ({suffix}) of a trained "
            f"MelSpectrogram's state ({len(state_u)} tensors, {path.stat().st_size} bytes): "
            f"state and output bit-equal {'ok' if same else 'FAIL'}")
        if not same:
            fail(f"(u) the {suffix} checkpoint does not restore the state bit for bit")
    trace_dir = out_dir / "trace"
    with torch.no_grad(), utils.trace(str(trace_dir)) as where:
        st_t(xu)
    newest = max(Path(where).glob("*.json"), key=lambda f: f.stat().st_mtime)
    named = PROFILE_NAMES["framed_magnitude"] in newest.read_text()
    log(f"[path] (u) profiling.trace around one (b) call: {newest.name} "
        f"({newest.stat().st_size} bytes) names {PROFILE_NAMES['framed_magnitude']}: "
        f"{'yes' if named else 'NO'}")
    shutil.rmtree(out_dir)
    if not named:
        fail("(u) the profiler trace does not name K1's kernel")
    del mel_u, xu, state_u

    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the slice's path")

    # ---------------------------------------------------------- 5. timing --
    timings = {}
    config.set_matmul_precision("highest")

    def stft_lib(x, n_fft, hop, window):
        return torch.stft(x, n_fft, hop, window=window, center=False,
                          return_complex=True)

    def time_set(mode):
        config.set_matmul_precision(mode)
        esz = 2 if mode == "default" else 4
        # the least time the card could take, whichever unit a kernel uses
        peak = PEAK_BF16 if mode == "default" else PEAK_TF32

        def kernel_ms(fn):
            return cuda_ms(fn, queue_ahead=True)
        rows = {}
        with torch.no_grad():
            # K1 at (b): STFT 2048/512, B=32, T=431, F=1025
            wc, ws = fourier(2048)
            win = STFT(n_fft=2048, hop_length=512, verbose=False, device=dev).window_mask
            x = F.pad(randn(batch, sr_b * secs)[:, None], (1024, 1024), mode="reflect")[:, 0]
            b, length = x.shape
            f, n, t = 1025, 2048, 431
            flops = 4 * b * t * f * n
            nbytes = esz * (b * length + 2 * f * n) + 4 * b * f * t
            rows["framed_magnitude"] = dict(
                ms=kernel_ms(lambda: fk.framed_magnitude(x, wc, ws, 512)),
                plain_ms=kernel_ms(lambda: fk.framed_magnitude_plain(x, wc, ws, 512)),
                library_ms=kernel_ms(lambda: stft_lib(x, 2048, 512, win).abs()),
                flops=flops, bytes=nbytes,
                shape=f"B={b} L={length} n_fft={n} hop=512 F={f} T={t}")
            # K2 at (a): classifier frontend 1024/256, B=32, T=626, F=513, M=64
            wc2, ws2 = fourier(1024)
            win2 = STFT(n_fft=1024, hop_length=256, verbose=False, device=dev).window_mask
            fb = MelSpectrogram(sr=sr_a, n_fft=1024, hop_length=256, n_mels=64,
                                verbose=False, device=dev).mel_basis
            x2 = F.pad(randn(batch, sr_a * secs)[:, None], (512, 512), mode="reflect")[:, 0]
            b2, length2 = x2.shape
            f2, n2, t2, m2 = 513, 1024, 626, 64
            rows["framed_filterbank"] = dict(
                ms=kernel_ms(lambda: dense_k2(x2, wc2, ws2, fb, 256, eps=1e-8)),
                plain_ms=kernel_ms(lambda: fk.framed_filterbank_plain(x2, wc2, ws2, fb, 256, eps=1e-8)),
                library_ms=kernel_ms(lambda: fb @ (stft_lib(x2, 1024, 256, win2).abs() ** 2 + 1e-8)),
                flops=4 * b2 * t2 * f2 * n2 + 2 * b2 * t2 * f2 * m2,
                bytes=esz * (b2 * length2 + 2 * f2 * n2 + m2 * f2) + 4 * b2 * m2 * t2,
                shape=f"B={b2} L={length2} n_fft={n2} hop=256 F={f2} T={t2} M={m2}")
            # K2 at (c): Mel-128 2048/512, B=32, T=431, F=1025
            fb_c = MelSpectrogram(sr=sr_b, n_fft=2048, hop_length=512, n_mels=128,
                                  verbose=False, device=dev).mel_basis
            rows["framed_filterbank (c)"] = dict(
                ms=kernel_ms(lambda: dense_k2(x, wc, ws, fb_c, 512, eps=1e-8)),
                plain_ms=kernel_ms(lambda: fk.framed_filterbank_plain(x, wc, ws, fb_c, 512, eps=1e-8)),
                library_ms=kernel_ms(lambda: fb_c @ (stft_lib(x, 2048, 512, win).abs() ** 2 + 1e-8)),
                flops=flops + 2 * b * t * f * 128,
                bytes=esz * (b * length + 2 * f * n + 128 * f) + 4 * b * 128 * t,
                shape=f"B={b} L={length} n_fft={n} hop=512 F={f} T={t} M=128")
            if mode == "highest":
                # K2's FFT route at (c), the Mel cells' call: its bound counts
                # a real FFT of each frame and the bank's nonzero entries
                nnz_c = int((fb_c != 0).sum())
                rows["framed_filterbank_fft"] = dict(  # the STFT's and the Mel's own
                    ms=kernel_ms(lambda: fk.framed_filterbank(x, wc, ws, fb_c, 512)),
                    plain_ms=kernel_ms(lambda: fk.framed_filterbank_fft_plain(x, wc, ws, fb_c, 512)),
                    library_ms=kernel_ms(lambda: fb_c @ stft_lib(x, 2048, 512, win).abs() ** 2),
                    library="fb @ torch.stft().abs() ** 2",
                    flops=b * t * fft_frame_flops(n, nnz_c),
                    bytes=4 * (b * length + 128 * b * t),
                    shape=f"B={b} L={length} n_fft={n} hop=512 F={f} T={t} M=128, "
                          f"{nnz_c} nonzero")
                # and its mixed-radix kernel at Whisper large-v3's call (B=32
                # 30 s windows, n_fft 400, hop 160, 128 mels): the held Mel's
                # own basis, the padded signal in and the (B, M, T) mel out;
                # dense K2 on the same operands beside it
                mel_w = WhisperLogMel(device=dev).melspec_layer
                wc_w, ws_w, fb_w = mel_w.wcos, mel_w.wsin, mel_w.mel_basis
                x_w = F.pad(randn(batch, 480000)[:, None], (200, 200), mode="reflect")[:, 0]
                nnz_w, t_w = int((fb_w != 0).sum()), 3001
                rows["framed_filterbank_fft N=400"] = dict(
                    ms=kernel_ms(lambda: fk.framed_filterbank(x_w, wc_w, ws_w, fb_w, 160)),
                    dense_ms=kernel_ms(lambda: dense_k2(x_w, wc_w, ws_w, fb_w, 160)),
                    plain_ms=kernel_ms(lambda: fk.framed_filterbank_fft_plain(
                        x_w, wc_w, ws_w, fb_w, 160)),
                    library_ms=kernel_ms(lambda: fb_w @ stft_lib(
                        x_w, 400, 160, torch.hann_window(400, device=dev)).abs() ** 2),
                    library="fb @ torch.stft().abs() ** 2",
                    flops=batch * t_w * fft_frame_flops(400, nnz_w),
                    bytes=4 * (x_w.numel() + 128 * batch * t_w),
                    shape=f"B={batch} L={x_w.shape[1]} n_fft=400 hop=160 F=201 T={t_w} "
                          f"M=128, {nnz_w} nonzero")
                log(f"[time] highest  framed_filterbank_fft N=400: dense K2 on the same "
                    f"operands {rows['framed_filterbank_fft N=400']['dense_ms']:.3f} ms")
                del x_w
            # K3 at (d): synthesis 2048/512, B=32, T=431, F=1025; and at (e):
            # mel -> audio's 1024/256, T=862, F=513
            def fold_lib(sre, sim, kc, ks, hop):
                fr = (torch.einsum("fj,bft->bjt", kc, sre)
                      - torch.einsum("fj,bft->bjt", ks, sim))
                out_len = kc.shape[1] + hop * (sre.shape[-1] - 1)
                return F.fold(fr, output_size=(1, out_len), kernel_size=(1, kc.shape[1]),
                              stride=(1, hop))
            # and at (n)'s collapsed dual bank of CQT2010v2() at its defaults
            for key, (kc, ks), hop, t3 in (("synthesis_ola", (wc / n, ws / n), 512, t),
                                           ("synthesis_ola (e)", (wc2 / n2, ws2 / n2), 256, 862),
                                           ("synthesis_ola (n) pyramid", duals["(n) default"],
                                            512, 431)):
                f3, n3 = kc.shape
                sre, sim = randn(batch, f3, t3), randn(batch, f3, t3)
                args = (sre, sim, kc, ks, hop)
                rows[key] = dict(
                    ms=kernel_ms(lambda: fk.synthesis_ola(*args)),
                    plain_ms=kernel_ms(lambda: fk.synthesis_ola_plain(*args)),
                    library_ms=kernel_ms(lambda: fold_lib(*args)),
                    library="unfold-matmul + F.fold",
                    flops=4 * batch * t3 * f3 * n3,
                    bytes=esz * (2 * batch * f3 * t3 + 2 * f3 * n3)
                    + 4 * batch * (n3 + hop * (t3 - 1)),
                    shape=f"B={batch} F={f3} T={t3} n_fft={n3} hop={hop}")
                del sre, sim
            if mode == "highest":
                # K3's FFT route at the Griffin-Lim cell's call (B=32, T=862)
                # and the synthesis stream's step (B=128, T=4), 1024/256:
                # beside dense K3 on the same spectra, its mirror, and
                # torch.fft.irfft + F.fold as the library's yardstick. Its
                # bound counts an inverse real FFT and the overlap-add's adds
                # a frame (bench_port/work); the bytes, the spectra in and
                # the signal out
                ist_e = iSTFT(n_fft=1024, hop_length=256, verbose=False, device=dev)
                w_e = ist_e.window_mask
                kc_e, ks_e = fk.synthesis_kernels(ist_e.kernel_cos, ist_e.kernel_sin, w_e)

                def irfft_lib(sre, sim, hop=256):
                    fr = torch.fft.irfft(torch.complex(sre, sim), 1024, dim=1) * w_e[:, None]
                    out_len = 1024 + hop * (sre.shape[-1] - 1)
                    return F.fold(fr, output_size=(1, out_len), kernel_size=(1, 1024),
                                  stride=(1, hop))
                for key, b3, t3 in (("synthesis_ola_fft", batch, 862),
                                    ("synthesis_ola_fft stream", 128, 4)):
                    sre, sim = randn(b3, 513, t3), randn(b3, 513, t3)
                    args = (sre, sim, kc_e, ks_e, 256)
                    dense = (sre, sim, kc_e.clone(), ks_e.clone(), 256)  # copies: no factors
                    rows[key] = dict(
                        ms=kernel_ms(lambda: fk.synthesis_ola(*args)),
                        dense_ms=kernel_ms(lambda: fk.synthesis_ola(*dense)),
                        plain_ms=kernel_ms(lambda: fk.synthesis_ola_fft_plain(
                            sre, sim, w_e / 1024, 256)),
                        library_ms=kernel_ms(lambda: irfft_lib(sre, sim)),
                        library="torch.fft.irfft + F.fold",
                        flops=b3 * t3 * (2.5 * 1024 * np.log2(1024) + 1024),
                        bytes=4 * (2 * b3 * 513 * t3 + b3 * (1024 + 256 * (t3 - 1))),
                        shape=f"B={b3} F=513 T={t3} n_fft=1024 hop=256")
                    log(f"[time] highest  {key}: dense K3 on the same spectra "
                        f"{rows[key]['dense_ms']:.3f} ms")
                    del sre, sim
            # K5 at (b)'s shape (the fp32 Griffin-Lim loop's analysis, (f))
            rows["framed_pair"] = dict(
                ms=kernel_ms(lambda: fk.framed_pair(x, wc, ws, 512)),
                plain_ms=kernel_ms(lambda: fk.framed_pair_plain(x, wc, ws, 512)),
                library_ms=kernel_ms(lambda: torch.view_as_real(
                    stft_lib(x, 2048, 512, win))),
                flops=flops, bytes=esz * (b * length + 2 * f * n) + 2 * 4 * b * f * t,
                shape=f"B={b} L={length} n_fft={n} hop=512 F={f} T={t}")
            # K1 and K5 on one 10 s clip: 4 x 9 tiles for 132 SMs
            x1 = x[:1].contiguous()
            for key, kernel, plain, lib, out_bytes in (
                    ("framed_magnitude B=1", fk.framed_magnitude,
                     fk.framed_magnitude_plain,
                     lambda: stft_lib(x1, 2048, 512, win).abs(), 4 * f * t),
                    ("framed_pair B=1", fk.framed_pair, fk.framed_pair_plain,
                     lambda: torch.view_as_real(stft_lib(x1, 2048, 512, win)),
                     2 * 4 * f * t)):
                rows[key] = dict(
                    ms=kernel_ms(lambda: kernel(x1, wc, ws, 512)),
                    plain_ms=kernel_ms(lambda: plain(x1, wc, ws, 512)),
                    library_ms=kernel_ms(lib),
                    flops=flops // b, bytes=esz * (length + 2 * f * n) + out_bytes,
                    shape=f"B=1 L={length} n_fft={n} hop=512 F={f} T={t}")
            # K4 at (e)'s step shape, bf16 carries: mel -> audio 1024/256,
            # B=32, T=862, F=513; S is fp32, 2 carries in and 4 out
            x4 = F.pad(randn(batch, sr_b * secs)[:, None], (512, 512), mode="reflect")[:, 0]
            b4, length4 = x4.shape
            f4, n4, t4 = 513, 1024, 862
            win4 = STFT(n_fft=1024, hop_length=256, verbose=False, device=dev).window_mask
            S4 = torch.rand(b4, f4, t4, generator=gen, device=dev)
            p4 = [randn(b4, f4, t4).bfloat16() for _ in range(2)]

            def gl_lib():
                X = stft_lib(x4, n4, 256, win4)
                return fk.gl_update(X.real, -X.imag, S4, *p4, MOM)
            if mode == "highest":
                # K4's FFT route at the same step with fp32 carries (the
                # Griffin-Lim cell's): the padded signal in, S and two
                # carries in, four out; a real FFT a frame and 12 operations
                # a bin (bench_port's count). Beside it the pair (K5) and the
                # update, the route it replaces
                p4f = [randn(b4, f4, t4) for _ in range(2)]

                def gl_lib_fp32():
                    X = stft_lib(x4, n4, 256, win4)
                    return fk.gl_update(X.real, -X.imag, S4, *p4f, MOM)
                wc4, ws4 = wc2.clone(), ws2.clone()  # not the STFT's own: the pair
                rows["gl_step_fft"] = dict(
                    ms=kernel_ms(lambda: fk.gl_step(x4, wc2, ws2, S4, *p4f, 256, MOM)),
                    pair_ms=kernel_ms(lambda: fk.gl_step(x4, wc4, ws4, S4, *p4f, 256, MOM)),
                    plain_ms=kernel_ms(lambda: fk.gl_step_fft_plain(
                        x4, wc2, ws2, S4, *p4f, 256, MOM)),
                    library_ms=kernel_ms(gl_lib_fp32),
                    library="torch.stft + the elementwise update",
                    flops=b4 * t4 * (2.5 * n4 * np.log2(n4) + 12 * f4),
                    bytes=4 * (b4 * length4 + 7 * b4 * f4 * t4),
                    shape=f"B={b4} L={length4} n_fft={n4} hop=256 F={f4} T={t4}, fp32 carries")
                log(f"[time] highest  gl_step_fft: the pair (K5) and the update on the same "
                    f"step {rows['gl_step_fft']['pair_ms']:.3f} ms")
                del p4f, wc4, ws4
                # the NNLS kernel at the inversion cell's call: 32 mels of 862
                # frames, 80 mels to 8 kHz (727 nonzero entries), 64 steps;
                # the least work is bench_port's (roofline_pct.NNLS.invert):
                # the dense seed and 4 a nonzero entry and column each step,
                # M and pinv(M) and the mels in, s out. Beside it the seed
                # alone, and the 129 products and ATen steps it replaces
                inv5 = InverseMelSpectrogram(sr=sr_b, n_fft=1024, hop_length=256, n_mels=80,
                                             fmax=8000.0, verbose=False, device=dev)
                m5, f5 = inv5.mel_basis.shape
                nz5 = int((inv5.mel_basis != 0).sum())
                mel5 = torch.einsum("mf,bft->bmt", inv5.mel_basis,
                                    torch.rand(batch, f5, t4, generator=gen, device=dev) ** 4)
                nnls5 = (inv5.mel_basis, inv5.mel_pinv, mel5, inv5._step)
                rows["nnls_banded"] = dict(
                    ms=kernel_ms(lambda: fk.nnls(*nnls5, 64)),
                    seed_ms=kernel_ms(lambda: fk.nnls(*nnls5, 0)),
                    plain_ms=kernel_ms(lambda: fk.nnls_banded_plain(*nnls5, 64)),
                    library_ms=kernel_ms(lambda: fk.nnls_plain(*nnls5, 64)),
                    library="the 129 fp32 products and the ATen steps (the plain route)",
                    flops=batch * t4 * (2 * f5 * m5 + 64 * 4 * nz5),
                    bytes=4 * (2 * m5 * f5 + batch * m5 * t4 + batch * f5 * t4),
                    shape=f"B={batch} M={m5} F={f5} T={t4}, {nz5} nonzero entries, 64 steps")
                log(f"[time] highest  nnls_banded: the seed kernel alone "
                    f"{rows['nnls_banded']['seed_ms']:.3f} ms")
                del inv5, mel5, nnls5
            rows["gl_step"] = dict(
                ms=kernel_ms(lambda: fk.gl_step(x4, wc2, ws2, S4, *p4, 256, MOM)),
                plain_ms=kernel_ms(lambda: fk.gl_step_plain(x4, wc2, ws2, S4, *p4, 256, MOM)),
                library_ms=kernel_ms(gl_lib),
                library="composite: torch.stft + the elementwise update",
                flops=4 * b4 * t4 * f4 * n4,
                bytes=esz * (b4 * length4 + 2 * f4 * n4) + (4 + 6 * 2) * b4 * f4 * t4,
                shape=f"B={b4} L={length4} n_fft={n4} hop=256 F={f4} T={t4}, bf16 carries")
            # K6 at (g): the CQT1992v2 bank, B=32 and one clip; K1 forced onto
            # the same inputs, and K6 over a range of split counts. Its bound
            # counts the products against the bank's nonzero entries (the
            # structural work, what any implementation of the function needs
            # on this bank); the dense count is printed beside it
            wc6, ws6 = cqt.cqt_kernels_real, cqt.cqt_kernels_imag
            f6, t6 = wc6.shape[0], 431
            nnz6 = int(((wc6.to(config.storage_dtype()) != 0)
                        | (ws6.to(config.storage_dtype()) != 0)).sum())
            for key, b6 in (("framed_magnitude_kchunk", batch),
                            ("framed_magnitude_kchunk B=1", 1)):
                x6 = randn(b6, len_cqt)

                def conv_lib():
                    xs6 = x6[:, None, :]
                    return torch.hypot(F.conv1d(xs6, wc6[:, None, :], stride=512),
                                       F.conv1d(xs6, ws6[:, None, :], stride=512))
                rows[key] = dict(
                    ms=kernel_ms(lambda: fk.framed_magnitude_kchunk(x6, wc6, ws6, 512)),
                    k1_ms=kernel_ms(lambda: fk.framed_magnitude(x6, wc6, ws6, 512)),
                    plain_ms=kernel_ms(lambda: fk.framed_magnitude_plain(x6, wc6, ws6, 512)),
                    library_ms=kernel_ms(conv_lib),
                    library="2 x F.conv1d(stride=hop) + torch.hypot",
                    flops=4 * b6 * t6 * nnz6, dense_flops=4 * b6 * t6 * f6 * n_cqt,
                    bytes=esz * (b6 * len_cqt + 2 * f6 * n_cqt) + 4 * b6 * f6 * t6,
                    shape=f"B={b6} L={len_cqt} N={n_cqt} hop=512 F={f6} T={t6}")
                planned = fk.kchunk_plan(b6, t6, n_cqt)
                sweep = {s_: kernel_ms(lambda: fk.framed_magnitude_kchunk(
                    x6, wc6, ws6, 512, splits=s_)) for s_ in (1, 2, 3, 4, 6, 8, 10, 16, 32)}
                rows[key]["split_sweep_ms"] = sweep
                log(f"[time] {mode:8s} K6 B={b6} by split count (planned {planned}): "
                    + ", ".join(f"{s_}: {v:.3f} ms" for s_, v in sweep.items())
                    + f"; K1 at the same shape {rows[key]['k1_ms']:.3f} ms")
        for k, r in rows.items():
            t_ops, t_bytes = r["flops"] / peak * 1e3, r["bytes"] / HBM_BYTES * 1e3
            r["bound_ms"] = max(t_ops, t_bytes)
            r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            r["roofline_share"] = r["bound_ms"] / r["ms"]
            if r["roofline_share"] > 1:
                fail(f"{k} {mode}: {r['ms']} ms is below its bound {r['bound_ms']} ms")
            log(f"[time] {mode:8s} {k:18s} {r['shape']}: kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms"
                f"{' (' + r['library'] + ')' if 'library' in r else ''}, "
                f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
                f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, roofline share "
                f"{100 * r['roofline_share']:.1f}%"
                + (f"; dense count {r['dense_flops'] / 1e9:.2f} GFLOP, its bound "
                   f"{r['dense_flops'] / peak * 1e3:.3f} ms" if "dense_flops" in r else ""))
        return rows

    for mode in ("highest", "default"):
        gen = phase_gen(f"5 {mode}")
        timings[mode] = time_set(mode)
    config.set_matmul_precision("highest")

    # The K1 / K6 dispatch: both kernels on the same inputs (10 s clips at
    # 22.05 kHz, hop 512; (h)'s bank at its hop 128) over B = 1-32, on the
    # CQT banks and on dense random banks, and what the dispatch rule
    # (ops.dispatch.kchunk_envelope) loses where it picks the slower one
    gen = phase_gen("sweep")
    sweep_banks = [("CQT1992v2() 84x16384", wc_cqt, ws_cqt, 512),
                   ("(h) CQT1992v2 48x8192", cqt_h.cqt_kernels_real,
                    cqt_h.cqt_kernels_imag, 128),
                   ("CQT1992 dense 84x16384", *banks["cqt1992"], 512)]
    sweep_banks += [(f"dense {f}x{n}", randn(f, n) * 0.05, randn(f, n) * 0.05, 512)
                    for f in (64, 84, 128) for n in (2048, 4096, 8192, 16384)]
    sweep = []
    with torch.no_grad():
        for mode in ("highest", "default"):
            config.set_matmul_precision(mode)
            for label, wc, ws, hop in sweep_banks:
                f, n = wc.shape
                xs_all = randn(batch, sr_b * secs + n)
                for b in (1, 2, 4, 8, 16, 32):
                    xb = xs_all[:b]
                    k1 = cuda_ms(lambda: fk.framed_magnitude(xb, wc, ws, hop), queue_ahead=True)
                    k6 = cuda_ms(lambda: fk.framed_magnitude_kchunk(xb, wc, ws, hop),
                                 queue_ahead=True)
                    pick = "K6" if td.kchunk_envelope(f, n) else "K1"
                    loss = (k6 if pick == "K6" else k1) - min(k1, k6)
                    sweep.append(dict(mode=mode, bank=label, B=b, k1_ms=k1, k6_ms=k6,
                                      pick=pick, loss_ms=loss))
                    log(f"[sweep] {mode:8s} {label:22s} B={b:2d}: K1 {k1:.3f} ms, K6 "
                        f"{k6:.3f} ms, faster {'K6' if k6 < k1 else 'K1'}; the rule picks "
                        f"{pick}, loses {loss:.3f} ms ({100 * loss / min(k1, k6):.1f}%)")
                del xs_all
    config.set_matmul_precision("highest")
    for mode in ("highest", "default"):
        lost = [r for r in sweep if r["mode"] == mode and r["loss_ms"] > 0]
        log(f"[sweep] {mode:8s} the rule picks the slower kernel in {len(lost)} of "
            f"{sum(r['mode'] == mode for r in sweep)} cases, losing "
            f"{sum(r['loss_ms'] for r in lost):.3f} ms in all, at most "
            f"{max([r['loss_ms'] for r in lost], default=0.0):.3f} ms")
    log("[timings] " + json.dumps({"card": card, "results": results,
                                   "timings": timings, "sweep": sweep}))

    # -------------------------------------------------------- 6. summary --
    # (source, TPU kernel replaced, precision mode of the row: the mode the
    # kernel runs in on its path; K4 runs inside the bf16 Griffin-Lim loop)
    tensor_core = "nnaudio_tpu_torch/csrc/framed_tc.cu"
    meta = {
        "framed_magnitude": (tensor_core, "nnaudio_tpu/ops/framed_matmul.py:273", "highest"),
        "framed_filterbank": (tensor_core, "nnaudio_tpu/ops/framed_matmul.py:296", "highest"),
        "synthesis_ola": ("nnaudio_tpu_torch/csrc/synthesis_ola.cu",
                          "nnaudio_tpu/ops/framed_matmul.py:878", "highest"),
        "gl_step": (tensor_core, "nnaudio_tpu/ops/framed_matmul.py:239", "default"),
        "framed_pair": (tensor_core, "nnaudio_tpu/ops/framed_matmul.py:205", "highest"),
        "framed_magnitude_kchunk": ("nnaudio_tpu_torch/csrc/framed_kchunk.cu",
                                    "nnaudio_tpu/ops/framed_matmul.py:482", "highest"),
        "framed_filterbank_fft": ("nnaudio_tpu_torch/csrc/framed_fft.cu",
                                  "nnaudio_tpu/ops/framed_matmul.py:296", "highest"),
        "synthesis_ola_fft": ("nnaudio_tpu_torch/csrc/framed_fft.cu",
                              "nnaudio_tpu/ops/framed_matmul.py:878", "highest"),
        "gl_step_fft": ("nnaudio_tpu_torch/csrc/framed_fft.cu",
                        "nnaudio_tpu/ops/framed_matmul.py:239", "highest"),
        "nnls_banded": ("nnaudio_tpu_torch/csrc/nnls_banded.cu",
                        "none (nnaudio_tpu/features/inverse_mel.py mel_to_power: einsum)",
                        "highest"),
    }
    kernels = []
    for k, (src, replaces, mode) in meta.items():
        r = timings[mode][k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": max_abs[k],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
