"""The port's core and framed ops (their CPU paths, i.e. the kernels' plain
versions) against the JAX package on the same numpy inputs."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu.core import frame as jframe
from nnaudio_tpu.core import overlap as joverlap
from nnaudio_tpu.features.stft import hermitian_weights as j_hermitian_weights
from nnaudio_tpu.filters.fourier import create_fourier_basis
from nnaudio_tpu.ops import dispatch as jd
from nnaudio_tpu.ops import framed_matmul
from nnaudio_tpu_torch.core import frame as tframe
from nnaudio_tpu_torch.core import overlap as toverlap
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
        fk._launch_synthesis(torch.zeros(1, 65, 4), torch.zeros(1, 65, 4), w, w, 32)
    with pytest.raises(TypeError, match="float32"):
        fk._operand(torch.zeros(2, 3, dtype=torch.float64), "x", 2, torch.device("cpu"))
