"""The port's core and framed ops (their CPU paths, i.e. the kernels' plain
versions) against the JAX package on the same numpy inputs."""
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu.core import apply as japply
from nnaudio_tpu.core import frame as jframe
from nnaudio_tpu.core import overlap as joverlap
from nnaudio_tpu.core import resample as jresample
from nnaudio_tpu.features.stft import hermitian_weights as j_hermitian_weights
from nnaudio_tpu.filters.fourier import create_fourier_basis
from nnaudio_tpu.ops import dispatch as jd
from nnaudio_tpu.ops import framed_matmul
from nnaudio_tpu_torch.core import apply as tapply
from nnaudio_tpu_torch.core import frame as tframe
from nnaudio_tpu_torch.core import overlap as toverlap
from nnaudio_tpu_torch.core import resample as tresample
from nnaudio_tpu_torch.filters import create_lowpass_filter
from nnaudio_tpu_torch.ops import dispatch as td
from nnaudio_tpu_torch.ops import framed_kernels as fk

TOL = 1e-4  # tests/test_ops.py's framed-op tolerance


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=tol, atol=tol), np.abs(got - want).max()


@pytest.mark.parametrize("L,W,hop", [
    (1000, 256, 64), (1000, 256, 8), (500, 509, 256), (300, 100, 100),
    (300, 100, 150), (100, 7, 3), (64, 64, 1), (400, 130, 1),
])
def test_frame_signal_geometries(L, W, hop):
    x = np.random.RandomState(0).randn(3, L).astype(np.float32)
    t = jframe.num_frames(L, W, hop)
    assert tframe.num_frames(L, W, hop) == t
    if t <= 0:
        with pytest.raises(RuntimeError):
            tframe.frame_signal(torch.from_numpy(x), W, hop)
        return
    got = tframe.frame_signal(torch.from_numpy(x), W, hop)
    assert got._is_view()  # framing copies nothing
    want = np.asarray(jframe.frame_signal(jnp.asarray(x), W, hop))
    assert np.array_equal(got.numpy(), want)
    # overlap-add matches the JAX package's
    fr = np.random.RandomState(1).randn(3, t, W).astype(np.float32)
    _close(tframe.frames_to_signal(torch.from_numpy(fr), hop, L),
           jframe.frames_to_signal(jnp.asarray(fr), hop, L), 1e-5)


def test_frames_to_signal_is_adjoint():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    fr = torch.from_numpy(rng.randn(2, 15, 8).astype(np.float32))
    lhs = torch.sum(tframe.frame_signal(x, 8, 4) * fr)
    rhs = torch.sum(x * tframe.frames_to_signal(fr, 4, 64))
    assert np.isclose(float(lhs), float(rhs), rtol=1e-5)


def test_pad_signal_reflect_and_error():
    x = np.random.RandomState(2).randn(2, 50).astype(np.float32)
    for mode in ("reflect", "constant"):
        _close(tframe.pad_signal(torch.from_numpy(x), 16, mode),
               jframe.pad_signal(jnp.asarray(x), 16, mode), 0)
    with pytest.raises(ValueError, match="shorter than reflect"):
        tframe.pad_signal(torch.zeros(1, 10), 10)


def test_overlap_helpers():
    w = np.hanning(16).astype(np.float32)
    _close(toverlap.window_sumsquare(torch.from_numpy(w), 5, 4, 16),
           joverlap.window_sumsquare(jnp.asarray(w), 5, 4, 16), 1e-6)
    sig = np.random.RandomState(3).randn(2, 32).astype(np.float32)
    env = np.abs(np.random.RandomState(4).randn(32)).astype(np.float32)
    env[::5] = 0.0
    _close(toverlap.normalize_by_window_envelope(torch.from_numpy(sig), torch.from_numpy(env)),
           joverlap.normalize_by_window_envelope(jnp.asarray(sig), jnp.asarray(env)), 1e-6)
    X = np.random.RandomState(5).randn(1, 9, 4, 2).astype(np.float32)
    _close(toverlap.extend_fbins(torch.from_numpy(X)),
           joverlap.extend_fbins(jnp.asarray(X)), 0)


def _inputs(n_fft, hop, batch=2, frames=12, seed=0):
    """A signal and windowed Fourier bases, as an STFT would see them."""
    rng = np.random.RandomState(seed)
    basis = create_fourier_basis(n_fft, window="hann")
    wcos = basis.wcos * basis.window_mask[None, :]
    wsin = basis.wsin * basis.window_mask[None, :]
    x = rng.randn(batch, n_fft + hop * (frames - 1) + hop // 3).astype(np.float32)
    return x, wcos, wsin


GEOMETRIES = [(1024, 256), (512, 160), (400, 100)]


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_framed_ops_match_jax(n_fft, hop):
    x, wcos, wsin = _inputs(n_fft, hop)
    f = wcos.shape[0]
    fb = np.abs(np.random.RandomState(6).randn(24, f)).astype(np.float32) / f
    scale = np.random.RandomState(7).rand(f).astype(np.float32)
    tx, tc, ts = map(torch.from_numpy, (x, wcos, wsin))
    jx, jc, js = map(jnp.asarray, (x, wcos, wsin))

    for got, want in zip(td.framed_basis_pair(tx, tc, ts, hop),
                         jd.framed_basis_pair(jx, jc, js, hop)):
        _close(got, want)
    _close(td.framed_complex(tx, tc, ts, None, hop),
           jd.framed_complex(jx, jc, js, None, hop))
    _close(td.framed_complex(tx, tc, ts, torch.from_numpy(scale), hop),
           jd.framed_complex(jx, jc, js, jnp.asarray(scale), hop))
    for eps in (0.0, 1e-8):
        _close(td.framed_magnitude(tx, tc, ts, hop, eps),
               jd.framed_magnitude(jx, jc, js, hop, eps))
        _close(td.framed_filterbank(tx, tc, ts, torch.from_numpy(fb), hop, eps),
               jd.framed_filterbank(jx, jc, js, jnp.asarray(fb), hop, eps))
    _close(td.framed_power(tx, tc, ts, hop), jd.framed_power(jx, jc, js, hop))

    rng = np.random.RandomState(8)
    t = (x.shape[1] - n_fft) // hop + 1
    sre = rng.randn(2, f, t).astype(np.float32)
    sim = rng.randn(2, f, t).astype(np.float32)
    kc, ks = wcos / n_fft, wsin / n_fft
    _close(td.synthesis_ola(*map(torch.from_numpy, (sre, sim, kc, ks)), hop),
           jd.synthesis_ola(*map(jnp.asarray, (sre, sim, kc, ks)), hop))


def test_plain_versions_differentiate_on_cpu():
    x, wcos, wsin = _inputs(512, 160, batch=1, frames=4)
    wc = torch.from_numpy(wcos).requires_grad_()
    out = td.framed_magnitude(torch.from_numpy(x), wc, torch.from_numpy(wsin), 160, 1e-8)
    out.sum().backward()
    assert wc.grad is not None and torch.isfinite(wc.grad).all()


def _interpreted(fn, *args, **kw):
    framed_matmul._INTERPRET = True
    try:
        return fn(*args, **kw)
    finally:
        framed_matmul._INTERPRET = False


def test_plain_versions_match_interpreted_pallas():
    """K1, K2 and K3's plain versions against the Pallas kernels themselves
    (interpreted), at one small aligned shape."""
    n_fft, hop = 512, 128
    x, wcos, wsin = _inputs(n_fft, hop, frames=24)
    f = wcos.shape[0]
    fb = np.abs(np.random.RandomState(9).randn(16, f)).astype(np.float32) / f
    tx, tc, ts, tfb = map(torch.from_numpy, (x, wcos, wsin, fb))
    jx, jc, js, jfb = map(jnp.asarray, (x, wcos, wsin, fb))

    _close(fk.framed_magnitude_plain(tx, tc, ts, hop, eps=1e-8),
           _interpreted(framed_matmul.framed_magnitude_pallas, jx, jc, js, hop,
                        highest=True, eps=1e-8))
    _close(fk.framed_magnitude_plain(tx, tc, ts, hop, square=True),
           _interpreted(framed_matmul.framed_magnitude_pallas, jx, jc, js, hop,
                        highest=True, square=True))
    _close(fk.framed_filterbank_plain(tx, tc, ts, tfb, hop, eps=1e-8),
           _interpreted(framed_matmul.framed_filterbank_pallas, jx, jc, js, jfb,
                        hop, highest=True, eps=1e-8))

    wt = np.asarray(j_hermitian_weights(n_fft, f))
    basis = create_fourier_basis(n_fft, window="hann")
    kc = basis.wcos * wt[:, None] * basis.window_mask[None, :] / n_fft
    ks = basis.wsin * wt[:, None] * basis.window_mask[None, :] / n_fft
    rng = np.random.RandomState(10)
    sre = rng.randn(2, f, 21).astype(np.float32)
    sim = rng.randn(2, f, 21).astype(np.float32)
    _close(fk.synthesis_ola_plain(*map(torch.from_numpy, (sre, sim, kc, ks)), hop),
           _interpreted(framed_matmul.synthesis_ola_pallas,
                        *map(jnp.asarray, (sre, sim, kc, ks)), hop, highest=True))


def test_kernel_switch_off_selects_plain_version():
    from nnaudio_tpu_torch import config

    x, wcos, wsin = _inputs(512, 160, batch=1, frames=4)
    args = tuple(map(torch.from_numpy, (x, wcos, wsin)))
    on = td.framed_magnitude(*args, 160)
    config.set_use_pallas(False)
    try:
        assert not config.analysis_kernel_enabled()
        assert not config.synthesis_kernel_enabled()
        off = td.framed_magnitude(*args, 160)
    finally:
        config.set_use_kernels(True)
    assert torch.equal(on, off)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 4096)
    w = torch.zeros(65, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_magnitude(x, w, w, 32, 0.0, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_magnitude_kchunk(x, torch.zeros(65, 4096), torch.zeros(65, 4096),
                                    32, 0.0, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_synthesis(torch.zeros(1, 65, 4), torch.zeros(1, 65, 4), w, w, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_filterbank(x, w, w, torch.zeros(8, 65), 32, 0.0)
    with pytest.raises(TypeError, match="float32"):
        fk._operand(torch.zeros(2, 3, dtype=torch.float64), "x", 2, torch.device("cpu"))


def test_cqt_output_helpers_match_jax():
    rng = np.random.RandomState(11)
    re, im = rng.randn(2, 5, 7).astype(np.float32), rng.randn(2, 5, 7).astype(np.float32)
    _close(tapply.phase_unit_stack(torch.from_numpy(re), torch.from_numpy(im)),
           japply.phase_unit_stack(jnp.asarray(re), jnp.asarray(im)), 1e-6)
    kr, ki = rng.randn(4, 5).astype(np.float32), rng.randn(4, 5).astype(np.float32)
    got = tapply.complex_bank_mul(*map(torch.from_numpy, (kr, ki, re, im)))
    want = japply.complex_bank_mul(*map(jnp.asarray, (kr, ki, re, im)))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("length,n,pad", [
    (1000, 2, None), (1001, 2, None), (999, 4, None), (4097, 4, None),
    (5000, 4, 127 * 3), (300, 2, 0), (255, 2, None),
])
def test_downsample_by_n_matches_jax(length, n, pad):
    x = np.random.RandomState(12).randn(2, length).astype(np.float32)
    fir = create_lowpass_filter(1 / n, 256, 0.03 if n > 2 else 0.001)
    got = tresample.downsample_by_n(torch.from_numpy(x), torch.from_numpy(fir), n, pad=pad)
    _close(got, jresample.downsample_by_n(jnp.asarray(x), jnp.asarray(fir), n, pad=pad), 1e-5)
    if n == 2 and pad is None:
        assert torch.equal(got, tresample.downsample_by_2(torch.from_numpy(x), torch.from_numpy(fir)))


@pytest.mark.parametrize("length", [0, 1])
def test_downsample_by_n_of_a_signal_shorter_than_the_fir_is_empty(length):
    fir = create_lowpass_filter(0.5, 256, 0.001)
    x = np.zeros((3, length), np.float32)
    got = tresample.downsample_by_n(torch.from_numpy(x), torch.from_numpy(fir), 2)
    want = jresample.downsample_by_n(jnp.asarray(x), jnp.asarray(fir), 2)
    assert tuple(got.shape) == tuple(want.shape) == (3, 0)


@pytest.mark.parametrize("batch,length,f,n,hop,kw", [
    (2, 16384, 84, 8192, 512, dict()),
    (2, 16384, 84, 8192, 512, dict(square=True, eps=1e-8)),
    (1, 12000, 64, 4096, 320, dict()),
])
def test_kchunk_plain_version_matches_interpreted_pallas(batch, length, f, n, hop, kw):
    """K6's contract: ``framed_magnitude_plain`` against the Pallas K-chunked
    kernel itself (interpreted), at the JAX suite's two cases."""
    rng = np.random.RandomState(40)
    x = rng.randn(batch, length).astype(np.float32)
    wcos = (rng.randn(f, n) * 0.05).astype(np.float32)
    wsin = (rng.randn(f, n) * 0.05).astype(np.float32)
    plan = framed_matmul._plan_kchunk(batch, n, f, (length - n) // hop + 1, hop, True)
    assert plan is not None and plan["nk"] > 1
    want = _interpreted(framed_matmul._framed_magnitude_kchunk, jnp.asarray(x),
                        jnp.asarray(wcos).T, jnp.asarray(wsin).T, hop,
                        highest=True, **kw, **plan)
    tx, tc, ts = map(torch.from_numpy, (x, wcos, wsin))
    _close(fk.framed_magnitude_plain(tx, tc, ts, hop, **kw), want)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = dict(fk.LAUNCHES)
    _close(fk.framed_magnitude_kchunk(tx, tc, ts, hop, **kw), want)
    assert fk.LAUNCHES == before


def test_magnitude_dispatch_routes_agree_on_cpu(monkeypatch):
    """Inside K6's envelope the magnitude ops call K6's wrapper, outside K1's;
    on CPU tensors both are the one plain version."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(1, 6000).astype(np.float32))
    calls = []
    for name in ("framed_magnitude", "framed_magnitude_kchunk"):
        real = getattr(fk, name)
        monkeypatch.setattr(fk, name, lambda *a, _n=name, _f=real, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    for f, n, route in ((8, td.KCHUNK_MIN_N, "framed_magnitude_kchunk"),
                        (8, td.KCHUNK_MIN_N - 1, "framed_magnitude"),
                        (129, td.KCHUNK_MIN_N, "framed_magnitude")):
        wc = torch.from_numpy((rng.randn(f, n) * 0.05).astype(np.float32))
        ws = torch.from_numpy((rng.randn(f, n) * 0.05).astype(np.float32))
        del calls[:]
        mag = td.framed_magnitude(x, wc, ws, 200, eps=1e-8)
        power = td.framed_power(x, wc, ws, 200)
        assert calls == [route, route]
        assert torch.equal(mag, fk.framed_magnitude_plain(x, wc, ws, 200, eps=1e-8))
        assert torch.equal(power, fk.framed_magnitude_plain(x, wc, ws, 200, square=True))


@pytest.mark.parametrize("f,n,inside", [
    (128, 2048, True), (129, 2048, False), (128, 2047, False), (1, 2048, True),
    (84, 16384, True), (84, 2049, True), (1025, 2048, False), (1025, 16384, False),
])
def test_kchunk_envelope(f, n, inside):
    assert td.KCHUNK_MIN_N == 2048 and fk.KCHUNK_MAX_F == 128
    assert td.kchunk_envelope(f, n) is inside


@pytest.mark.parametrize("b,t,n,splits", [
    (32, 431, 16384, None), (1, 431, 16384, None), (2, 17, 8192, None),
    (1, 41, 5000, None), (1, 41, 5000, 7), (1000, 431, 16384, None),
    (1, 1, 20, None), (1, 3, 4096, 1), (2, 9, 4097, 500),
])
def test_kchunk_plan_covers_k_without_an_empty_split(b, t, n, splits):
    """The split count: at least one and at most one per K chunk; planned,
    a function of the shapes alone that keeps the grid within one wave of
    KCHUNK_TARGET_BLOCKS and every split KCHUNK_MIN_SPLIT_K samples of K on
    average; asked for, never more than asked."""
    got = fk.kchunk_plan(b, t, n, splits)
    assert 1 <= got <= -(-n // fk.KCHUNK_BK[torch.float32])
    base = b * -(-t // fk.KCHUNK_BT)
    if splits is None:
        assert got == fk.kchunk_plan(b, t, n)  # the shapes alone decide
        assert got == 1 or (n // got >= fk.KCHUNK_MIN_SPLIT_K
                            and got * base <= fk.KCHUNK_TARGET_BLOCKS)
    else:
        assert got <= splits
    if base >= fk.KCHUNK_TARGET_BLOCKS:
        assert got == 1  # enough blocks already: one split, no second pass


def _tf32_cases():
    rng = np.random.RandomState(20)
    half = np.float32(2.0 ** -11)  # half a TF32 unit at 1.0
    return {
        "random": rng.randn(4096).astype(np.float32),
        "wide exponents": (rng.randn(4096) * 10.0 ** rng.uniform(-20, 20, 4096)).astype(np.float32),
        "ties": np.array([1 + half, 1 + 3 * half, 2 + 2 * half, 1 + half / 2], np.float32),
        "negative": -np.abs(rng.randn(4096)).astype(np.float32),
        "zeros": np.array([0.0, -0.0], np.float32),
    }


@pytest.mark.parametrize("case", list(_tf32_cases()))
def test_tf32_split(case):
    """hi holds 10 mantissa bits, hi + lo reproduces the input to 2^-21, the
    rounding is to nearest with ties away from zero, and odd in its input."""
    v = _tf32_cases()[case]
    hi, lo = fk.tf32_split(torch.from_numpy(v))
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    v64 = v.astype(np.float64)
    err = np.abs(hi.double().numpy() + lo.double().numpy() - v64)
    assert (err <= 2.0 ** -21 * np.abs(v64)).all()
    # |v - hi| is at most half a TF32 unit of v
    assert (np.abs(v64 - hi.double().numpy()) <= 2.0 ** -11 * np.abs(v64)).all()
    neg_hi, neg_lo = fk.tf32_split(torch.from_numpy(-v))
    assert torch.equal(neg_hi, -hi) and torch.equal(neg_lo, -lo)
    if case == "ties":
        unit = 2.0 ** -10
        assert hi.tolist() == [1 + unit, 1 + 2 * unit, 2 + 2 * unit, 1.0]
    if case == "zeros":
        assert hi.tolist() == [0.0, 0.0] and lo.tolist() == [0.0, 0.0]
        assert bool(torch.signbit(hi)[1]) and not bool(torch.signbit(hi)[0])


@pytest.mark.parametrize("f,n,hop", [(65, 2048, 512), (84, 16384, 512), (201, 400, 3)])
def test_3xtf32_plain_pair_is_as_accurate_as_fp32(f, n, hop):
    """Three TF32 products of the split operands against an fp64 product:
    within 4x of the plain fp32 version's error and 1e-5 of max |ref|."""
    rng = np.random.RandomState(21)
    frames = 6
    x = rng.randn(2, n + hop * (frames - 1)).astype(np.float32)
    wcos = rng.randn(f, n).astype(np.float32)
    wsin = rng.randn(f, n).astype(np.float32)
    fr = np.stack([x[:, i * hop:i * hop + n] for i in range(frames)], 1).astype(np.float64)
    tx, tc, ts = map(torch.from_numpy, (x, wcos, wsin))
    got = fk.framed_pair_3xtf32_plain(tx, tc, ts, hop)
    plain = fk.framed_pair_plain(tx, tc, ts, hop)
    for w, g, p in zip((wcos, wsin), got, plain):
        ref = np.einsum("fn,btn->bft", w.astype(np.float64), fr)
        scale = np.abs(ref).max()
        e_split = np.abs(g.numpy() - ref).max() / scale
        e_plain = np.abs(p.numpy() - ref).max() / scale
        assert g.shape == p.shape == ref.shape
        assert e_split <= 4 * e_plain and e_split <= 1e-5, (e_split, e_plain)


@pytest.mark.parametrize("length,f,n,hop", [(4096, 129, 1024, 256), (2048, 65, 512, 128)])
def test_3xtf32_plain_pair_matches_interpreted_pallas(length, f, n, hop):
    """K5's tensor-core arithmetic, repeated in plain PyTorch, against the
    Pallas pair kernel itself (interpreted), as tests/test_ops.py drives it."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, length).astype(np.float32)
    wcos = rng.randn(f, n).astype(np.float32)
    wsin = rng.randn(f, n).astype(np.float32)
    jx, jc, js = map(jnp.asarray, (x, wcos, wsin))
    assert framed_matmul.framed_matmul_pair_supported(jx, jc, hop)
    want = _interpreted(framed_matmul.framed_matmul_pair_pallas, jx, jc, js, hop)
    got = fk.framed_pair_3xtf32_plain(*map(torch.from_numpy, (x, wcos, wsin)), hop)
    for g, w in zip(got, want):
        _close(g, w)


# the JAX suite's two analysis cases (tests/test_ops.py:121-183) as (batch,
# length, bins, n_fft, hop), with 40 and 7 mels, and the first with 300 mels
# (five 64-row tiles of the kernel's projection)
FILTERBANK_CASES = [(2, 4096, 129, 1024, 256, 40), (1, 512, 17, 64, 16, 7),
                    (2, 4096, 129, 1024, 256, 300)]


def _filterbank_inputs(batch, length, f, n, m, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, length).astype(np.float32)
    wcos = rng.randn(f, n).astype(np.float32)
    wsin = rng.randn(f, n).astype(np.float32)
    fb = (np.abs(rng.randn(m, f)) / f).astype(np.float32)
    return x, wcos, wsin, fb


@pytest.mark.parametrize("batch,length,f,n,hop,m", FILTERBANK_CASES)
def test_3xtf32_plain_filterbank_matches_plain_and_interpreted_pallas(
        batch, length, f, n, hop, m):
    """K2's tensor-core arithmetic in fp32 storage (split pair, split
    projection in 32-bin chunks of 128-bin tiles), repeated in plain
    PyTorch, against the plain version and against the Pallas filterbank
    kernel (interpreted): within 1e-4 of max |ref|, the fp32 tolerance."""
    x, wcos, wsin, fb = _filterbank_inputs(batch, length, f, n, m)
    got = fk.framed_filterbank_3xtf32_plain(*map(torch.from_numpy, (x, wcos, wsin, fb)),
                                            hop, eps=1e-8)
    plain = fk.framed_filterbank_plain(*map(torch.from_numpy, (x, wcos, wsin, fb)),
                                       hop, eps=1e-8)
    want = np.asarray(_interpreted(framed_matmul.framed_filterbank_pallas,
                                   *map(jnp.asarray, (x, wcos, wsin, fb)), hop,
                                   highest=True, eps=1e-8))
    assert got.shape == plain.shape == want.shape
    scale = np.abs(want).max()
    assert float((got - plain).abs().max()) / scale <= 1e-4
    assert np.abs(got.numpy() - want).max() / scale <= 1e-4


@pytest.mark.parametrize("batch,length,f,n,hop,m", FILTERBANK_CASES[:2])
def test_3xtf32_plain_filterbank_is_as_accurate_as_fp32(batch, length, f, n, hop, m):
    """Against an fp64 filterbank of the fp64 power, the 3xTF32 arithmetic
    errs at most 4x as much as the plain fp32 version."""
    x, wcos, wsin, fb = _filterbank_inputs(batch, length, f, n, m)
    frames = np.stack([x[:, i * hop:i * hop + n]
                       for i in range((length - n) // hop + 1)], 1).astype(np.float64)
    re = np.einsum("fn,btn->bft", wcos.astype(np.float64), frames)
    im = np.einsum("fn,btn->bft", wsin.astype(np.float64), frames)
    ref = np.einsum("mf,bft->bmt", fb.astype(np.float64), re * re + im * im + 1e-8)
    args = tuple(map(torch.from_numpy, (x, wcos, wsin, fb)))
    e_split = np.abs(fk.framed_filterbank_3xtf32_plain(*args, hop, eps=1e-8).numpy()
                     - ref).max() / np.abs(ref).max()
    e_plain = np.abs(fk.framed_filterbank_plain(*args, hop, eps=1e-8).numpy()
                     - ref).max() / np.abs(ref).max()
    assert e_split <= 4 * e_plain, (e_split, e_plain)


@pytest.mark.parametrize("batch,length,f,n,hop,m", FILTERBANK_CASES[:2])
def test_filterbank_plain_in_bf16_storage_matches_interpreted_pallas(
        batch, length, f, n, hop, m):
    """The plain version in ``default`` mode (operands rounded to bf16, as
    the kernel reads them) against the Pallas kernel at DEFAULT precision
    (interpreted, which keeps fp32 storage): within 5e-2 of max |ref|, the
    bf16 tolerance."""
    from nnaudio_tpu_torch import config

    x, wcos, wsin, fb = _filterbank_inputs(batch, length, f, n, m)
    want = np.asarray(_interpreted(framed_matmul.framed_filterbank_pallas,
                                   *map(jnp.asarray, (x, wcos, wsin, fb)), hop,
                                   highest=False, eps=1e-8))
    config.set_matmul_precision("default")
    try:
        got = fk.framed_filterbank_plain(*map(torch.from_numpy, (x, wcos, wsin, fb)),
                                         hop, eps=1e-8)
    finally:
        config.set_matmul_precision("highest")
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 5e-2


# (B, F, T, N, hop): the slice's hops, an odd hop, hop 3, and the flat CQT
# inverse's bank (84 bins of 16384 samples at hop 128)
SYNTHESIS_CASES = [(2, 65, 9, 2048, 512), (2, 100, 7, 2048, 441), (2, 129, 12, 1024, 256),
                   (2, 257, 15, 512, 128), (1, 201, 40, 400, 3), (1, 84, 12, 16384, 128)]


def test_synthesis_compensates_only_long_sums():
    """K3 adds each step by a compensated sum only where a row's fp32 running
    sum is longer than KAHAN_MIN_STEPS; the kernel's launcher and the plain
    twin read the same limit, and SYNTHESIS_CASES hold both kinds."""
    import re
    src = (Path(fk.__file__).resolve().parent.parent / "csrc" / "synthesis_ola.cu").read_text()
    limit = re.search(r"constexpr int KAHAN_MIN_STEPS = (\d+);", src)
    assert limit and int(limit.group(1)) == fk.SYNTH_KAHAN_MIN_STEPS
    assert not fk.synthesis_compensated(1025, 2048, 512)  # (b): 264 steps
    assert fk.synthesis_compensated(201, 400, 3)  # hop 3: 1876 steps
    kinds = {fk.synthesis_compensated(f, n, hop) for _, f, _, n, hop in SYNTHESIS_CASES}
    assert kinds == {False, True}


@pytest.mark.parametrize("b,f,t,n,hop", SYNTHESIS_CASES)
def test_3xtf32_plain_synthesis_matches_plain_and_jax(b, f, t, n, hop):
    """K3's tensor-core arithmetic in fp32 storage (the split operands, each
    step of 32 bins added to the running sum, by a compensated sum where the
    sum is long, the
    overlap-add inside the K loop),
    repeated in plain PyTorch, against the plain version and the JAX
    package's ``synthesis_ola`` (1e-4), and against fp64 (within 4x the
    plain fp32 version's error)."""
    rng = np.random.RandomState(31)
    sre, sim = (rng.randn(b, f, t).astype(np.float32) for _ in range(2))
    kc, ks = ((rng.randn(f, n) / n).astype(np.float32) for _ in range(2))
    args = list(map(torch.from_numpy, (sre, sim, kc, ks)))
    got = fk.synthesis_ola_3xtf32_plain(*args, hop)
    plain = fk.synthesis_ola_plain(*args, hop)
    _close(got, plain)
    _close(got, jd.synthesis_ola(*map(jnp.asarray, (sre, sim, kc, ks)), hop))
    frames = (np.einsum("fj,bft->btj", kc.astype(np.float64), sre)
              - np.einsum("fj,bft->btj", ks.astype(np.float64), sim))
    ref = tframe.frames_to_signal(torch.from_numpy(frames), hop, n + hop * (t - 1)).numpy()
    scale = np.abs(ref).max()
    e_split = np.abs(got.numpy() - ref).max() / scale
    e_plain = np.abs(plain.numpy() - ref).max() / scale
    assert e_split <= 4 * e_plain, (e_split, e_plain)
