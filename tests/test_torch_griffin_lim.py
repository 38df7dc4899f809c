"""Griffin-Lim, the mel -> audio inverses, and the plain versions of the K4
(Griffin-Lim step) and K5 (pair) kernels against the JAX package on the same
numpy inputs, on the CPU. The random initial phase is the one JAX draws,
handed to the port as ``rand_phase``."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu.ops import dispatch as jd
from nnaudio_tpu.ops import framed_matmul
from nnaudio_tpu_torch import config
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.interop import load_jax_state
from nnaudio_tpu_torch.ops import dispatch as td
from nnaudio_tpu_torch.ops import framed_kernels as fk
from test_torch_training import kernel_route  # noqa: F401  (a fixture: launches counted)

MOM = 0.99 / 1.99
# Griffin-Lim loop against Griffin-Lim loop (tests/test_ops.py:731,782):
# fp32 carries, and bf16 carries (which the port also stores bf16 operands
# for, where JAX's CPU matmuls stay fp32)
GL_TOL = {"highest": 5e-4, "default": 3e-2}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=tol, atol=tol), np.abs(got - want).max()


def _rel_err(got, want):
    """max |got - want| / max |want|"""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _interpreted(fn, *args, **kw):
    framed_matmul._INTERPRET = True
    try:
        return fn(*args, **kw)
    finally:
        framed_matmul._INTERPRET = False


def _tones(sr=16000, seconds=0.5, batch=1, seed=0):
    """Seeded harmonic clips: a tone with three overtones plus a sweep."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    clips = []
    for _ in range(batch):
        f0 = rng.uniform(110, 440)
        x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
                for k in range(1, 5))
        fa, fb = rng.uniform(200, sr / 4, 2)
        x = x + 0.5 * np.sin(2 * np.pi * (fa * t + (fb - fa) * t * t / (2 * t[-1])))
        clips.append(x)
    return np.asarray(clips, np.float32)


# ------------------------------------------------------- K4, K5 plain versions --
@pytest.mark.parametrize("highest", [False, True])
def test_gl_step_plain_matches_interpreted_pallas(highest):
    """K4's plain version against ``_framed_gl_step`` (as
    tests/test_ops.py:564-606 runs it), compared on the true [:f, :t]."""
    rng = np.random.RandomState(50)
    b, n_fft, hop, length = 2, 512, 128, 8192
    f = n_fft // 2 + 1
    x = rng.randn(b, length).astype(np.float32)
    wcos = (rng.randn(f, n_fft) * 0.05).astype(np.float32)
    wsin = (rng.randn(f, n_fft) * 0.05).astype(np.float32)
    plan = framed_matmul.gl_step_plan(b, length, f, n_fft, hop, highest=highest)
    fp, tp = plan["f_padded"], plan["t_padded"]
    t = (length - n_fft) // hop + 1
    S = np.abs(rng.randn(b, fp, tp)).astype(np.float32)
    S[:, f:, :] = 0.0
    S[:, :, t:] = 0.0
    carry = jnp.float32 if highest else jnp.bfloat16
    p_re = jnp.asarray(rng.randn(b, fp, tp).astype(np.float32)).astype(carry)
    p_im = jnp.asarray(rng.randn(b, fp, tp).astype(np.float32)).astype(carry)
    static_plan = {k: plan[k] for k in ("w", "q", "n_chunks", "tile_t", "tile_f",
                                        "bb", "slab_rows", "t_padded", "f_padded")}
    want = _interpreted(framed_matmul._framed_gl_step, jnp.asarray(x),
                        jnp.asarray(wcos).T, jnp.asarray(wsin).T, jnp.asarray(S),
                        p_re, p_im, hop, mom=MOM, highest=highest, **static_plan)

    t_carry = torch.float32 if highest else torch.bfloat16

    def true_shape(a):
        return torch.from_numpy(np.array(a[:, :f, :t], np.float32))

    got = fk.gl_step_plain(torch.from_numpy(x), torch.from_numpy(wcos),
                           torch.from_numpy(wsin), true_shape(S),
                           true_shape(p_re).to(t_carry),
                           true_shape(p_im).to(t_carry), hop, MOM)
    assert all(g.dtype == t_carry for g in got)
    tol = 1e-4 if highest else 2e-2  # bf16 outputs: tests/test_ops.py:596
    for g, w in zip(got, want):
        _close(g, np.asarray(w[:, :f, :t], np.float32), tol)


@pytest.mark.parametrize("b,length,n_fft,hop", [(2, 4096, 1024, 256), (1, 512, 64, 16)])
def test_3xtf32_plain_gl_step_matches_plain_and_interpreted_pallas(b, length, n_fft, hop):
    """K4's tensor-core arithmetic in fp32 storage (the split pair, then
    ``gl_update``), repeated in plain PyTorch, against the plain version and
    against ``_framed_gl_step`` (interpreted, fp32 carries), at the JAX
    suite's two analysis cases (tests/test_ops.py:121-183): 1e-4, the fp32
    tolerance."""
    rng = np.random.RandomState(51)
    f = n_fft // 2 + 1
    x = rng.randn(b, length).astype(np.float32)
    wcos = (rng.randn(f, n_fft) / np.sqrt(n_fft)).astype(np.float32)
    wsin = (rng.randn(f, n_fft) / np.sqrt(n_fft)).astype(np.float32)
    plan = framed_matmul.gl_step_plan(b, length, f, n_fft, hop, highest=True)
    fp, tp = plan["f_padded"], plan["t_padded"]
    t = (length - n_fft) // hop + 1
    S = np.abs(rng.randn(b, fp, tp)).astype(np.float32)
    S[:, f:, :] = 0.0
    S[:, :, t:] = 0.0
    p_re = rng.randn(b, fp, tp).astype(np.float32)
    p_im = rng.randn(b, fp, tp).astype(np.float32)
    static_plan = {k: plan[k] for k in ("w", "q", "n_chunks", "tile_t", "tile_f",
                                        "bb", "slab_rows", "t_padded", "f_padded")}
    want = _interpreted(framed_matmul._framed_gl_step, jnp.asarray(x),
                        jnp.asarray(wcos).T, jnp.asarray(wsin).T, jnp.asarray(S),
                        jnp.asarray(p_re), jnp.asarray(p_im), hop, mom=MOM,
                        highest=True, **static_plan)
    args = [torch.from_numpy(a) for a in (x, wcos, wsin)]
    carries = [torch.from_numpy(np.ascontiguousarray(a[:, :f, :t])) for a in (S, p_re, p_im)]
    got = fk.gl_step_3xtf32_plain(*args, *carries, hop, MOM)
    plain = fk.gl_step_plain(*args, *carries, hop, MOM)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.float32
        _close(g, p)
        _close(g, np.asarray(w[:, :f, :t], np.float32))


def test_pair_plain_matches_interpreted_pallas():
    """K5's plain version against ``framed_matmul_pair_pallas``
    (tests/test_ops.py:103-115)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4096).astype(np.float32)
    wcos = rng.randn(129, 1024).astype(np.float32)
    wsin = rng.randn(129, 1024).astype(np.float32)
    want = _interpreted(framed_matmul.framed_matmul_pair_pallas,
                        *map(jnp.asarray, (x, wcos, wsin)), 256)
    got = fk.framed_pair_plain(*map(torch.from_numpy, (x, wcos, wsin)), 256)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 160)])
def test_pair_grads_match_jax(n_fft, hop, monkeypatch):
    """``framed_complex``'s gradients (plain autograd on the CPU) and K5's
    backward (``framed_pair_backward``, dW in chunks of 3 frames here)
    against ``jax.grad`` through the JAX ops."""
    rng = np.random.RandomState(21)
    f = n_fft // 2 + 1
    x = rng.randn(2, n_fft + 11 * hop + 7).astype(np.float32)
    wcos = (rng.randn(f, n_fft) / np.sqrt(n_fft)).astype(np.float32)
    wsin = (rng.randn(f, n_fft) / np.sqrt(n_fft)).astype(np.float32)
    scale = rng.rand(f).astype(np.float32)
    t = (x.shape[1] - n_fft) // hop + 1
    gout = rng.randn(2, f, t, 2).astype(np.float32)

    def jloss(x, wcos, wsin, scale):
        return jnp.sum(jd.framed_complex(x, wcos, wsin, scale, hop) * gout)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, wcos, wsin, scale)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wcos, wsin, scale)]
    loss = (td.framed_complex(*leaves, hop) * torch.from_numpy(gout)).sum()
    loss.backward()
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)

    def jpair_loss(x, wcos, wsin):
        pair = jd.framed_basis_pair(x, wcos, wsin, hop)
        return jnp.sum(jnp.stack(pair, -1) * gout)

    want = jax.grad(jpair_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, wcos, wsin)))
    monkeypatch.setattr(fk, "DW_CHUNK_ELEMS", 2 * n_fft * 3)
    got = fk.framed_pair_backward(*map(torch.from_numpy, (x, wcos, wsin)),
                                  torch.from_numpy(gout[..., 0]),
                                  torch.from_numpy(gout[..., 1]), hop)
    for g, w in zip(got, want):
        _close(g, w)


def test_gl_step_and_pair_wrappers_reject_bad_operands():
    x = torch.zeros(1, 4096)
    w = torch.zeros(65, 128)
    carry = torch.zeros(1, 65, 125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_pair(x, w, w, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._launch_gl_step(x, w, w, carry, carry, carry, 32, MOM)
    with pytest.raises(ValueError, match="shape"):
        fk._carry(carry, "S", (1, 65, 124), torch.float32, torch.device("cpu"))
    with pytest.raises(TypeError, match="bfloat16"):
        fk._carry(carry.double(), "p_re", (1, 65, 125), torch.float32,
                  torch.device("cpu"))


# --------------------------------------------------------------- Griffin-Lim --
def _gl_pair(n_iter, center, iter_precision, n_fft=512, hop=128, seed=3):
    """The same magnitudes through JAX's ``gl._forward`` and the port's
    Griffin_Lim, with the phase JAX drew handed to the port."""
    x = _tones()
    stft = jf.STFT(n_fft=n_fft, hop_length=hop, center=center,
                   output_format="Magnitude", verbose=False)
    S = np.asarray(stft(x))
    kw = dict(n_fft=n_fft, hop_length=hop, n_iter=n_iter, center=center,
              iter_precision=iter_precision)
    jgl = jf.Griffin_Lim(**kw)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.jit(jgl._forward)(dict(jgl._params), jnp.asarray(S), key))
    rand_phase = np.asarray(jax.random.normal(key, S.shape))
    got = tf.Griffin_Lim(device="cpu", **kw)(S, rand_phase=rand_phase)
    return stft, S, got.numpy(), want


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("iter_precision", ["highest", "default"])
def test_griffin_lim_matches_jax(center, iter_precision):
    _, _, got, want = _gl_pair(2, center, iter_precision)
    assert _rel_err(got, want) < GL_TOL[iter_precision]


@pytest.mark.parametrize("iter_precision", ["highest", "default"])
def test_griffin_lim_spectral_convergence_matches_jax(iter_precision):
    """At 16 iterations the port lands at JAX's spectral convergence
    (tests/test_ops.py:647-648)."""
    stft, S, got, want = _gl_pair(16, True, iter_precision)

    def spec_err(rec):
        S_rec = np.asarray(stft(rec))
        return np.linalg.norm(S_rec - S) / np.linalg.norm(S)

    e_port, e_jax = spec_err(got), spec_err(want)
    assert e_port < 0.25, (e_port, e_jax)
    assert abs(e_port - e_jax) < 0.05, (e_port, e_jax)


def test_griffin_lim_phase_sources_and_precision_restore():
    """Without a phase the port draws from a generator seeded 0; the loop's
    precision change is undone afterwards; fused and unfused loops agree."""
    S = np.abs(np.random.RandomState(4).randn(1, 129, 20)).astype(np.float32)
    gl = tf.Griffin_Lim(n_fft=256, hop_length=64, n_iter=3, device="cpu")
    base = gl(S)
    assert torch.equal(base, gl(S, generator=torch.Generator().manual_seed(0)))
    phase = torch.randn(S.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(base, gl(S, rand_phase=phase))
    assert not torch.equal(base, gl(S, generator=torch.Generator().manual_seed(1)))
    assert config.get_config().matmul_precision == "highest"
    config.set_use_kernels(False)  # the unfused loop: pair + update
    try:
        assert torch.equal(base, gl(S))
    finally:
        config.set_use_kernels(True)
    with pytest.raises(ValueError, match="rand_phase"):
        gl(S, rand_phase=phase[:, :, :5])
    with pytest.raises(AssertionError):
        gl(S[0])


# ------------------------------------------------------------ inverse mel --
INV_KW = dict(sr=16000, n_fft=512, n_mels=40, hop_length=128)


def _mel(x, **kw):
    return np.array(jf.MelSpectrogram(verbose=False, **{**INV_KW, **kw})(x))


def test_mel_to_power_matches_jax():
    mel = _mel(_tones(batch=2))
    jinv = jf.InverseMelSpectrogram(n_iter_nnls=32, verbose=False, **INV_KW)
    tinv = tf.InverseMelSpectrogram(n_iter_nnls=32, verbose=False,
                                    device="cpu", **INV_KW)
    assert tinv._step == jinv._step
    want = jinv.mel_to_power(dict(jinv._params), jnp.asarray(mel))
    got = tinv.mel_to_power(tinv.params, torch.from_numpy(mel))
    assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("iter_precision", ["highest", "default"])
def test_inverse_mel_matches_jax(iter_precision):
    mel = _mel(_tones())
    kw = dict(n_iter_nnls=16, n_iter=2, iter_precision=iter_precision,
              verbose=False, **INV_KW)
    jinv = jf.InverseMelSpectrogram(**kw)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jinv(jnp.asarray(mel), key=key))
    f = INV_KW["n_fft"] // 2 + 1
    rand_phase = np.asarray(jax.random.normal(key, (1, f, mel.shape[2])))
    got = tf.InverseMelSpectrogram(device="cpu", **kw)(mel, rand_phase=rand_phase)
    assert _rel_err(got, want) < GL_TOL[iter_precision]


def test_mfcc_to_mel_matches_jax():
    x = _tones(batch=2)
    mfcc = np.array(jf.MFCC(n_mfcc=13, top_db=None, verbose=False, **INV_KW)(x))
    jinv = jf.InverseMFCC(n_mfcc=13, verbose=False, **INV_KW)
    tinv = tf.InverseMFCC(n_mfcc=13, verbose=False, device="cpu", **INV_KW)
    want = jinv.mfcc_to_mel(dict(jinv._params), jnp.asarray(mfcc))
    got = tinv.mfcc_to_mel(tinv.params, torch.from_numpy(mfcc))
    assert _rel_err(got, want) < 1e-4
    # the whole inverse, one Griffin-Lim iteration, with JAX's phase
    key = jax.random.PRNGKey(2)
    jinv1 = jf.InverseMFCC(n_mfcc=13, n_iter=1, n_iter_nnls=8,
                           iter_precision="highest", verbose=False, **INV_KW)
    tinv1 = tf.InverseMFCC(n_mfcc=13, n_iter=1, n_iter_nnls=8,
                           iter_precision="highest", verbose=False,
                           device="cpu", **INV_KW)
    phase = np.asarray(jax.random.normal(key, (2, 257, mfcc.shape[2])))
    assert _rel_err(tinv1(mfcc, rand_phase=phase),
                    jinv1(jnp.asarray(mfcc), key=key)) < GL_TOL["highest"]


@pytest.mark.parametrize("make", [
    lambda m, d: m.Griffin_Lim(n_fft=256, hop_length=64, **d),
    lambda m, d: m.InverseMelSpectrogram(verbose=False, **INV_KW, **d),
    lambda m, d: m.InverseMFCC(n_mfcc=13, verbose=False, **INV_KW, **d),
])
def test_state_dict_keys_match_jax_and_load(make):
    t = make(tf, dict(device="cpu"))
    j = make(jf, {})
    assert set(t.state_dict()) == set(j.state_dict())
    rng = np.random.RandomState(8)
    state = {k: np.asarray(v) * (1 + 0.1 * rng.rand(*np.shape(v)))
             for k, v in j.state_dict().items()}
    load_jax_state(t, state)
    for k, v in t.state_dict().items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), state[k].astype(np.float32)), k
    # the Griffin-Lim tensors are one set, shared with the held transforms
    inner = getattr(t, "inverse_mel", t)
    if hasattr(inner, "griffin_lim"):
        assert inner.griffin_lim.wcos is t.wcos


def test_perturbed_jax_state_reproduces_mel_to_power():
    mel = _mel(_tones())
    jinv = jf.InverseMelSpectrogram(n_iter_nnls=8, verbose=False, **INV_KW)
    rng = np.random.RandomState(9)
    state = {k: np.asarray(v) * (1 + 0.05 * rng.rand(*np.shape(v)))
             for k, v in jinv.state_dict().items()}
    jinv.load_state_dict(state)
    tinv = tf.InverseMelSpectrogram(n_iter_nnls=8, verbose=False, device="cpu",
                                    **INV_KW)
    load_jax_state(tinv, state)
    want = jinv.mel_to_power(dict(jinv._params), jnp.asarray(mel))
    assert _rel_err(tinv.mel_to_power(tinv.params, torch.from_numpy(mel)), want) < 1e-4


# ------------------------------------------------------- K3's FFT route --
@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256), (2048, 441)])
def test_the_fft_routes_istft_matches_jax(kernel_route, n_fft, hop):
    """An iSTFT's frozen Fourier factors take K3's FFT route on the card's
    branch (its plain mirror here), and the waveform meets the JAX
    package's iSTFT at the framed ops' 1e-4 of max |ref|."""
    x = _tones(seconds=0.4, batch=2)
    X = np.asarray(jf.STFT(n_fft=n_fft, hop_length=hop, verbose=False)(x))
    want = jf.iSTFT(n_fft=n_fft, hop_length=hop, verbose=False)(
        jnp.asarray(X), onesided=True, length=x.shape[1])
    got = tf.iSTFT(n_fft=n_fft, hop_length=hop, verbose=False, device="cpu")(
        X, onesided=True, length=x.shape[1])
    assert kernel_route["synthesis_ola_fft"] == 1 and kernel_route["synthesis_ola"] == 0
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("center", [True, False])
def test_griffin_lim_on_the_fft_route_matches_jax(kernel_route, center):
    """fp32 Griffin-Lim with every synthesis on K3's FFT route and every
    analysis step on K4's (their plain mirrors) against JAX's loop, at the
    loop's fp32 tolerance: n_iter steps on K4's route, no pair."""
    _, _, got, want = _gl_pair(2, center, "highest")
    assert kernel_route["synthesis_ola_fft"] == 3 and kernel_route["synthesis_ola"] == 0
    assert kernel_route["gl_step_fft"] == 2 and kernel_route["framed_pair"] == 0
    assert _rel_err(got, want) < GL_TOL["highest"]
