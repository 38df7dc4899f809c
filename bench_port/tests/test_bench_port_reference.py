"""The plain references against float64 NumPy at small sizes, the control's
TF32, and the frozen builders against the port's own."""
import numpy as np
import pytest
import torch
from scipy.signal import get_window

from bench_port.reference import builders, cqt84_22k, mel80_22k, mel128_22k, numerics

MEL = {"sr": 8000, "n_fft": 64, "hop_length": 16, "n_mels": 10, "window": "hann",
       "center": True, "pad_mode": "reflect", "power": 2.0, "htk": False,
       "fmin": 0.0, "fmax": None, "norm": 1}
INV = {"sr": 8000, "n_fft": 64, "hop_length": 16, "n_mels": 10, "window": "hann",
       "center": True, "pad_mode": "reflect", "power": 1.0, "htk": False,
       "fmin": 0.0, "fmax": 3000.0, "norm": 1, "momentum": 0.99}
CQT = {"sr": 8000, "hop_length": 64, "fmin": 200.0, "n_bins": 24, "bins_per_octave": 12,
       "filter_scale": 1, "norm": 1, "window": "hann", "center": True, "pad_mode": "reflect"}


def signal(b, n, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n))


def mel_numpy(x, s, center=True, eps=0.0):
    n, hop = s["n_fft"], s["hop_length"]
    if center:
        x = np.pad(x, ((0, 0), (n // 2, n // 2)), mode="reflect")
    t = (x.shape[1] - n) // hop + 1
    frames = np.stack([x[:, i * hop:i * hop + n] for i in range(t)], axis=1)
    spec = np.fft.rfft(frames * get_window("hann", n, fftbins=True), axis=-1)
    power = np.abs(spec) ** 2 + eps
    fb = builders.mel_filterbank(s["sr"], n, s["n_mels"])
    return np.einsum("mf,btf->bmt", fb, power)


def close(got, want, tol):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() / np.abs(want).max() < tol


def test_mel_reference_matches_numpy_fft():
    x = signal(3, 700)
    got = mel128_22k.offline(MEL, torch.tensor(x, dtype=torch.float32))
    assert close(got, mel_numpy(x, MEL), 2e-6)


def test_stream_reference_is_the_uncentred_mel():
    x = signal(2, 64 + 16 * 9)
    got = mel128_22k.stream(MEL, torch.tensor(x, dtype=torch.float32))
    assert got.shape == (2, 10, 10)
    assert close(got, mel_numpy(x, MEL, center=False), 2e-6)


def test_cqt_reference_matches_numpy_correlation():
    x = signal(2, 3000)
    kernels, lengths = builders.cqt_bank(CQT["sr"], CQT["fmin"], CQT["n_bins"], 12)
    width = kernels.shape[1]
    xp = np.pad(x, ((0, 0), (width // 2, width // 2)), mode="reflect")
    t = (xp.shape[1] - width) // 64 + 1
    frames = np.stack([xp[:, i * 64:i * 64 + width] for i in range(t)], axis=1)
    want = np.abs(np.einsum("btn,fn->bft", frames, kernels)) * np.sqrt(lengths)[:, None]
    got = cqt84_22k.offline(CQT, torch.tensor(x, dtype=torch.float32))
    assert close(got, want, 2e-6)


def test_cqt_bank_follows_the_published_wavelets():
    kernels, lengths = builders.cqt_bank(22050, 32.70, 84, 12)
    q = 1 / (2 ** (1 / 12) - 1)
    assert kernels.shape == (84, 16384)
    assert lengths[0] == np.ceil(q * 22050 / 32.70)
    np.testing.assert_allclose(np.abs(kernels).sum(axis=1), 1.0)  # L1 norm
    assert (np.count_nonzero(kernels, axis=1) == lengths - 1).all()  # Hann's one zero


def loss_and_grads_numpy(s, p, x, labels, eps=1e-8):
    """The classifier's loss and its gradients by hand in float64."""
    n, hop = s["n_fft"], s["hop_length"]
    xp = np.pad(x, ((0, 0), (n // 2, n // 2)), mode="reflect")
    t = (xp.shape[1] - n) // hop + 1
    fr = np.stack([xp[:, i * hop:i * hop + n] for i in range(t)], axis=1)  # b t n
    re, im = fr @ p["wcos"].T, fr @ p["wsin"].T  # b t f
    power = re ** 2 + im ** 2 + eps
    mel = power @ p["mel_basis"].T  # b t m
    feats = np.log(np.maximum(mel, 0) + 1e-6).mean(axis=1)  # b m
    logits = feats @ p["head_w"] + p["head_b"]
    z = logits - logits.max(axis=1, keepdims=True)
    prob = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    b = x.shape[0]
    loss = -np.log(prob[np.arange(b), labels]).mean()
    dlog = prob.copy()
    dlog[np.arange(b), labels] -= 1
    dlog /= b
    g = {"head_w": feats.T @ dlog, "head_b": dlog.sum(axis=0)}
    dmel = (dlog @ p["head_w"].T)[:, None, :] / t / (np.maximum(mel, 0) + 1e-6) * (mel > 0)
    g["mel_basis"] = np.einsum("btm,btf->mf", dmel, power)
    dpow = dmel @ p["mel_basis"]
    g["wcos"] = np.einsum("btf,btn->fn", 2 * re * dpow, fr)
    g["wsin"] = np.einsum("btf,btn->fn", 2 * im * dpow, fr)
    return loss, g


def test_train_reference_matches_a_hand_backward():
    s, t = MEL, {"n_classes": 3, "lr": 1e-3}
    gen = torch.Generator().manual_seed(5)
    p = mel128_22k.init_params(s, t, gen, "cpu")
    x = signal(4, 300, seed=1)
    labels = np.array([0, 2, 1, 2])
    losses, states = mel128_22k.train(s, t, p, [(torch.tensor(x, dtype=torch.float32),
                                                 torch.tensor(labels))])
    p64 = {k: v.double().numpy() for k, v in p.items()}
    loss, grads = loss_and_grads_numpy(s, p64, x, labels)
    assert losses[0] == pytest.approx(loss, rel=1e-5)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    with numerics.fp32():
        value = mel128_22k.loss(s, leaves, torch.tensor(x, dtype=torch.float32),
                                torch.tensor(labels))
    got = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
    for k, g in grads.items():
        assert np.linalg.norm(got[k].double().numpy() - g) <= 1e-4 * np.linalg.norm(g), k
        assert torch.equal(states[0][k], p[k] - t["lr"] * got[k]), k


def test_control_rounds_every_product_to_tf32():
    v = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, 3.0])
    assert numerics.to_tf32(v).tolist() == [1.0 + 2 ** -10, 1.0, 3.0]
    a = torch.randn(5, 40, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    b = torch.randn(40, 3, dtype=torch.float32, generator=torch.Generator().manual_seed(1))
    want = numerics.to_tf32(a) @ numerics.to_tf32(b)
    assert torch.equal(numerics.matmul(a, b, control=True), want)
    assert not torch.equal(numerics.matmul(a, b), want)
    a.requires_grad_()
    numerics.matmul(a, b, control=True).sum().backward()
    assert torch.equal(a.grad, numerics.to_tf32(torch.ones(5, 3)) @ numerics.to_tf32(b).T)


def test_control_reads_far_from_the_reference():
    x = torch.tensor(signal(2, 2000), dtype=torch.float32)
    ref, ctl = mel128_22k.offline(MEL, x), mel128_22k.offline(MEL, x, control=True)
    rel = (ctl - ref).double().norm() / ref.double().norm()
    assert 1e-5 < rel < 1e-2


def test_builders_match_the_ports_at_the_configurations():
    from nnaudio_tpu_torch.filters import cqt, fourier, mel

    np.testing.assert_allclose(builders.mel_filterbank(22050, 2048, 128),
                               mel.mel_filterbank(22050, 2048, 128), rtol=1e-6, atol=1e-9)
    basis = fourier.create_fourier_basis(2048, window="hann")
    wcos, wsin = builders.fourier_basis(2048)
    np.testing.assert_allclose(wcos, basis.wcos * basis.window_mask, atol=1e-6)
    np.testing.assert_allclose(wsin, basis.wsin * basis.window_mask, atol=1e-6)
    q = 1 / (2 ** (1 / 12) - 1)
    bank = cqt.create_cqt_kernels(q, 22050, 32.70, 84, 12, 1, "hann")
    kernels, lengths = builders.cqt_bank(22050, 32.70, 84, 12)
    np.testing.assert_allclose(kernels, bank.kernels, atol=1e-7)
    np.testing.assert_allclose(lengths, bank.lengths)


def frames_numpy(x, n, hop):
    t = (x.shape[1] - n) // hop + 1
    return np.stack([x[:, i * hop:i * hop + n] for i in range(t)], axis=1)


def invert_numpy(s, mel, phase, n_iter, n_iter_nnls):
    """NNLS and fast Griffin-Lim in float64 NumPy, through ``rfft`` and
    ``irfft``: (B, M, T) mels and (B, F, T) phases in cycles -> (B, L)."""
    n, hop = s["n_fft"], s["hop_length"]
    fb = builders.mel_filterbank(s["sr"], n, s["n_mels"], s["fmin"], s["fmax"])
    step = 1.0 / np.linalg.svd(fb, compute_uv=False)[0] ** 2
    spec = np.maximum(np.einsum("fm,bmt->bft", np.linalg.pinv(fb), mel), 0)
    for _ in range(n_iter_nnls):
        resid = np.einsum("mf,bft->bmt", fb, spec) - mel
        spec = np.maximum(spec - step * np.einsum("mf,bmt->bft", fb, resid), 0)
    mag = spec.transpose(0, 2, 1)  # (B, T, F); power 1
    w = get_window("hann", n, fftbins=True)
    t = mag.shape[1]
    length = n + hop * (t - 1)
    env = np.zeros(length)
    for i in range(t):
        env[i * hop:i * hop + n] += w ** 2

    def synth(c):
        frames = np.fft.irfft(c, n, axis=-1) * w
        out = np.zeros((c.shape[0], length))
        for i in range(t):
            out[:, i * hop:i * hop + n] += frames[:, i]
        return (out / np.where(env > 1e-10, env, 1.0))[:, n // 2:length - n // 2]

    mom = s["momentum"] / (1 + s["momentum"])
    c = mag * np.exp(2j * np.pi * phase.transpose(0, 2, 1))
    p = np.zeros_like(c)
    for _ in range(n_iter):
        xp = np.pad(synth(c), ((0, 0), (n // 2, n // 2)), mode="reflect")
        r = np.fft.rfft(frames_numpy(xp, n, hop) * w, axis=-1)
        nn = r - mom * p
        c, p = mag * nn / (np.abs(nn) + 1e-16), r
    return synth(c)


def test_mel80_reference_is_the_mel_of_the_magnitude():
    x = signal(3, 700)
    n = INV["n_fft"]
    xp = np.pad(x, ((0, 0), (n // 2, n // 2)), mode="reflect")
    spec = np.fft.rfft(frames_numpy(xp, n, 16) * get_window("hann", n, fftbins=True), axis=-1)
    fb = builders.mel_filterbank(INV["sr"], n, INV["n_mels"], INV["fmin"], INV["fmax"])
    want = np.einsum("mf,btf->bmt", fb, np.abs(spec))
    assert close(mel80_22k.offline(INV, torch.tensor(x, dtype=torch.float32)), want, 2e-6)


@pytest.mark.parametrize("n_iter,n_iter_nnls", [(0, 0), (0, 64), (3, 64)])
def test_inversion_reference_matches_numpy_ffts(n_iter, n_iter_nnls):
    x = torch.tensor(signal(3, 600, seed=2), dtype=torch.float32)
    mel = mel80_22k.offline(INV, x)
    phase = torch.rand(3, INV["n_fft"] // 2 + 1, mel.shape[-1],
                       generator=torch.Generator().manual_seed(3))
    got = mel80_22k.invert(INV, mel, phase, n_iter, n_iter_nnls)
    want = invert_numpy(INV, mel.double().numpy(), phase.double().numpy(), n_iter, n_iter_nnls)
    assert got.shape == want.shape == (3, 16 * (mel.shape[-1] - 1))
    assert close(got, want, 1e-5)


def test_inversion_reference_control_reads_far():
    x = torch.tensor(signal(2, 600, seed=4), dtype=torch.float32)
    mel = mel80_22k.offline(INV, x)
    phase = torch.rand(2, INV["n_fft"] // 2 + 1, mel.shape[-1],
                       generator=torch.Generator().manual_seed(5))
    ref = mel80_22k.invert(INV, mel, phase, 4, 16).double()
    ctl = mel80_22k.invert(INV, mel, phase, 4, 16, control=True).double()
    assert (ctl - ref).norm() / ref.norm() > 1e-3


def test_inversion_bases_match_the_ports_at_the_configuration():
    from nnaudio_tpu_torch.features import InverseMelSpectrogram

    s = {"sr": 22050, "n_fft": 1024, "n_mels": 80, "window": "hann", "fmin": 0.0,
         "fmax": 8000.0, "htk": False, "norm": 1}
    port = InverseMelSpectrogram(sr=22050, n_fft=1024, hop_length=256, n_mels=80, fmax=8000.0,
                                 power=1.0, verbose=False, device="cpu")
    b = mel80_22k.bases(s, "cpu")
    # both from float64 filterbanks that agree to 1e-6 (the test above)
    np.testing.assert_allclose(b["mel_basis"], port.mel_basis, rtol=1e-5, atol=1e-9)
    pinv = port.mel_pinv.numpy()
    np.testing.assert_allclose(b["mel_pinv"], pinv, rtol=1e-5, atol=1e-6 * np.abs(pinv).max())
    assert b["step"] == pytest.approx(port._step, rel=1e-6)
