"""K4's FFT route: the recognition of a transform's frozen Fourier basis, the
plain mirror of the kernel's arithmetic, and the route each Griffin-Lim
step takes; then, marked ``cuda`` (skipped without a card), the kernel
itself.

No JAX here: the cases marked ``cuda`` run on the card with
``python -m pytest tests/test_torch_gl_step_fft.py -q --noconftest``. The
CPU cases compare with float64 numpy and the plain step;
``tests/test_torch_griffin_lim.py`` holds the route against the JAX
package's Griffin-Lim.
"""
import contextlib

import numpy as np
import pytest
import torch

from nnaudio_tpu_torch import config, features
from nnaudio_tpu_torch.core.frame import frame_signal
from nnaudio_tpu_torch.ops import framed_kernels as fk

MOM = 0.99 / 1.99


def _rel(got, want):
    """Relative L2 error, in float64."""
    got, want = (np.asarray(a.detach().cpu().double() if isinstance(a, torch.Tensor) else a,
                            np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _max_rel(got, want, keep=None):
    """max |got - want| (where ``keep``) / max |want|."""
    d = (got.detach().cpu().double() - want.detach().cpu().double()).abs()
    if keep is not None:
        d = d * keep.cpu()
    return float(d.max() / want.detach().cpu().double().abs().max())


def _gl_errors(got, want, S, p_re, p_im):
    """(r error, c error where |n| >= 1e-2 rms|n|, max ||c| - S| / max S)."""
    r_err = max(_max_rel(got[k], want[k]) for k in (2, 3))
    n_abs = torch.hypot(want[2].double() - MOM * p_re.double(),
                        want[3].double() - MOM * p_im.double())
    keep = n_abs >= 1e-2 * n_abs.square().mean().sqrt()
    c_err = max(_max_rel(got[k], want[k], keep) for k in (0, 1))
    mag_err = float((torch.hypot(got[0], got[1]) - S).abs().max() / S.max())
    return r_err, c_err, mag_err


def _basis(n_fft, device="cpu"):
    """A Griffin-Lim's own basis (marked, frozen, fp32)."""
    gl = features.Griffin_Lim(n_fft=n_fft, device=device)
    return gl, gl.wcos, gl.wsin


def _step_inputs(b, n_fft, hop, t, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, n_fft + hop * (t - 1) + hop // 3, generator=g, device=device)
    shape = (b, n_fft // 2 + 1, t)
    S = torch.rand(shape, generator=g, device=device)
    p_re, p_im = (torch.randn(shape, generator=g, device=device) for _ in range(2))
    return x, S, p_re, p_im


@pytest.fixture
def plan_builds(monkeypatch):
    """The plans built while the test runs (each call of
    build_gl_step_fft_plan)."""
    built = []
    real = fk.build_gl_step_fft_plan

    def build_plan(*ops):
        built.append(real(*ops))
        return built[-1]
    monkeypatch.setattr(fk, "build_gl_step_fft_plan", build_plan)
    return built


@contextlib.contextmanager
def _kernel_route():
    """Every wrapper takes the branch of a CUDA tensor; each launcher
    computes its plain version, and the pair's and K4's two are counted."""
    calls = {"framed_pair": 0, "gl_step": 0, "gl_step_fft": 0}

    def count(name, plain):
        def run(*args):
            calls[name] += 1
            return plain(*args)
        return run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "_on_card", lambda t: True)
        mp.setattr(fk, "_launch_pair", count("framed_pair", fk.framed_pair_plain))
        mp.setattr(fk, "_launch_gl_step", count("gl_step", fk.gl_step_plain))
        mp.setattr(fk, "_launch_gl_step_fft", count(
            "gl_step_fft", lambda *args: fk.gl_step_fft_plain(*args[:-1])))
        mp.setattr(fk, "_launch_synthesis", fk.synthesis_ola_plain)
        mp.setattr(fk, "_launch_synthesis_fft", lambda sre, sim, hop, plan:
                   fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop))
        mp.setattr(fk, "_launch_nnls", lambda *args: fk.nnls_banded_plain(*args[:-1]))
        yield calls


# ---------------------------------------------------------------- the mirror --
@pytest.mark.parametrize("n_fft", [256, 1024, 2048])
def test_the_mirrors_real_fft_is_the_dft(n_fft):
    gl, wc, _ = _basis(n_fft)
    frames = torch.randn(3, 5, n_fft, generator=torch.Generator().manual_seed(n_fft))
    re, im = fk.rfft_plain(frames, wc[0])
    want = np.fft.rfft(frames.double().numpy() * wc[0].double().numpy())
    scale = np.abs(want).max()
    assert np.abs(re.double().numpy() - want.real).max() <= 1e-6 * scale
    assert np.abs(im.double().numpy() - want.imag).max() <= 1e-6 * scale


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("hop", ["quarter", 441])
@pytest.mark.parametrize("n_fft", [256, 1024, 2048])
def test_the_mirror_matches_the_plain_step(n_fft, hop, b):
    """gl_step_fft_plain against gl_step_plain (the dense pair, then the
    update) at fp32 tolerance, on an odd number of frames."""
    hop = n_fft // 4 if hop == "quarter" else hop
    _, wc, ws = _basis(n_fft)
    x, S, p_re, p_im = _step_inputs(b, n_fft, hop, 13, seed=hop)
    got = fk.gl_step_fft_plain(x, wc, ws, S, p_re, p_im, hop, MOM)
    want = fk.gl_step_plain(x, wc, ws, S, p_re, p_im, hop, MOM)
    assert all(o.shape == (b, n_fft // 2 + 1, 13) and o.dtype == torch.float32 for o in got)
    r_err, c_err, mag_err = _gl_errors(got, want, S, p_re, p_im)
    assert r_err <= 1e-5 and c_err <= 1e-4 and mag_err <= 1e-6, (r_err, c_err, mag_err)
    # r is the real FFT of the windowed frames, in float64
    X = np.fft.rfft(frame_signal(x.double(), n_fft, hop).numpy() * wc[0].double().numpy())
    X = X.transpose(0, 2, 1)
    scale = np.abs(X).max()
    assert np.abs(got[2].double().numpy() - X.real).max() <= 1e-6 * scale
    assert np.abs(got[3].double().numpy() - X.imag).max() <= 1e-6 * scale


# --------------------------------------------------------------- recognition --
@pytest.mark.parametrize("n_fft", [64, 512, 1024, 8192])
def test_a_griffin_lims_basis_is_recognised(n_fft):
    _, wc, ws = _basis(n_fft)
    carry = torch.zeros(1)
    plan = fk.gl_step_fft_plan(wc, ws, carry, carry)
    assert plan is not None and fk.gl_step_fft_plan(wc, ws, carry, carry) is plan
    assert torch.equal(plan.window, wc[0]) and torch.equal(plan.twiddle, fk.fft_twiddles(n_fft))


@pytest.mark.parametrize("case", ["n_fft 400", "random basis", "bases swapped"])
def test_other_bases_are_not_recognised(case):
    carry = torch.zeros(1)
    if case == "n_fft 400":
        _, wc, ws = _basis(400)
    else:
        _, wc, ws = _basis(512)
        if case == "random basis":
            wc, ws = torch.randn_like(wc), torch.randn_like(ws)
            fk.mark_own(wc, ws)
        else:
            wc, ws = ws, wc
    assert fk.gl_step_fft_plan(wc, ws, carry, carry) is None


def test_a_trainable_basis_bf16_carries_or_bf16_storage_is_never_checked(plan_builds):
    _, wc, ws = _basis(512)
    f32, b16 = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
    gc, gs = wc.clone().requires_grad_(), ws.clone().requires_grad_()
    fk.mark_own(gc, gs)  # marked, so that only the grad keeps them from the check
    assert fk.gl_step_fft_plan(gc, ws, f32, f32) is None
    assert fk.gl_step_fft_plan(wc, gs, f32, f32) is None
    assert fk.gl_step_fft_plan(wc, ws, b16, b16) is None
    assert fk.gl_step_fft_plan(wc, ws, f32, b16) is None
    with config.fast_mode():
        assert fk.gl_step_fft_plan(wc, ws, f32, f32) is None
    assert fk.gl_step_fft_plan(wc.clone(), ws.clone(), f32, f32) is None  # not marked
    assert plan_builds == []


def test_the_verdict_is_kept_until_the_basis_changes(plan_builds):
    gl, wc, ws = _basis(512)
    carry = torch.zeros(1)
    first = fk.gl_step_fft_plan(wc, ws, carry, carry)
    assert first is not None and len(plan_builds) == 1
    assert fk.gl_step_fft_plan(wc, ws, carry, carry) is first and len(plan_builds) == 1
    with torch.no_grad():
        wc[3, 7] += 0.5  # an in-place edit: checked again, and refused
    assert fk.gl_step_fft_plan(wc, ws, carry, carry) is None and len(plan_builds) == 2
    fresh = features.Griffin_Lim(n_fft=512, device="cpu")
    gl.load_state_dict(fresh.state_dict())
    assert fk.gl_step_fft_plan(wc, ws, carry, carry) is not None and len(plan_builds) == 3


# -------------------------------------------------------------------- routes --
ROUTES = [("own basis", "gl_step_fft"), ("tensorfloat32", "gl_step_fft"),
          ("bf16 carries", "gl_step"), ("bf16 carries, fast mode", "gl_step"),
          ("bf16 carries, tensorfloat32", "framed_pair"),
          ("fp32 carries, fast mode", "framed_pair"), ("basis requires grad", "framed_pair"),
          ("unmarked copy", "framed_pair"), ("n_fft 400", "framed_pair"),
          ("S requires grad", "framed_pair")]


@pytest.mark.parametrize("case,route", ROUTES)
def test_each_step_takes_its_route(case, route):
    """The ops layer's one decision: the FFT route for an own frozen Fourier
    basis in fp32 storage with fp32 carries, outside autograd; the
    tensor-core K4 for bf16 carries outside tensorfloat32; the pair and the
    update for the rest."""
    n_fft, hop = (400, 100) if case == "n_fft 400" else (512, 128)
    _, wc, ws = _basis(n_fft)
    x, S, p_re, p_im = _step_inputs(2, n_fft, hop, 9)
    if "bf16 carries" in case:
        p_re, p_im = p_re.bfloat16(), p_im.bfloat16()
    if case == "basis requires grad":
        wc, ws = wc.clone().requires_grad_(), ws.clone().requires_grad_()
        fk.mark_own(wc, ws)
    elif case == "unmarked copy":
        wc, ws = wc.clone(), ws.clone()
    elif case == "S requires grad":
        S = S.requires_grad_()
    mode = ("default" if "fast mode" in case
            else "tensorfloat32" if "tensorfloat32" in case else "highest")
    config.set_matmul_precision(mode)
    try:
        with _kernel_route() as calls:
            got = fk.gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
            want = fk.gl_step_plain(x, wc, ws, S, p_re, p_im, hop, MOM)
    finally:
        config.set_matmul_precision("highest")
    assert calls == {k: int(k == route) for k in calls}
    assert all(o.dtype == p_re.dtype for o in got)
    if route != "gl_step" and p_re.dtype == torch.float32:
        r_err, c_err, mag_err = _gl_errors([o.detach() for o in got], want, S.detach(),
                                           p_re, p_im)
        assert r_err <= 1e-5 and c_err <= 1e-4 and mag_err <= 1e-6


def _griffin_lim(n_iter=3, iter_precision="highest", n_fft=512, hop=128):
    gl = features.Griffin_Lim(n_fft=n_fft, hop_length=hop, n_iter=n_iter,
                              iter_precision=iter_precision, device="cpu")
    g = torch.Generator().manual_seed(6)
    S = torch.rand(2, n_fft // 2 + 1, 20, generator=g)
    return gl, S, torch.rand(S.shape, generator=g)


@pytest.mark.parametrize("iter_precision,route", [("highest", "gl_step_fft"),
                                                  ("default", "gl_step")])
def test_griffin_lim_asks_the_ops_layer_for_each_step(iter_precision, route):
    """fp32 carries take K4's FFT route every iteration, bf16 carries the
    tensor-core K4 as before; the fp32 loop on the route meets the plain
    loop."""
    gl, S, phase = _griffin_lim(iter_precision=iter_precision)
    with torch.no_grad():
        want = gl(S, rand_phase=phase)
        with _kernel_route() as calls:
            got = gl(S, rand_phase=phase)
    assert calls == {k: 3 * (k == route) for k in calls}
    if route == "gl_step_fft":
        assert _rel(got, want) <= 1e-4


def test_a_differentiated_griffin_lim_takes_the_pair_and_its_gradient():
    """With S requiring grad, every fp32 step takes the pair and the update
    (neither kernel has a backward), and the gradient to S is the plain
    loop's. The gradient is ill-conditioned in fp32 (c = S n/|n| over small
    |n|): the plain loop's own moves by 1.9-4.8e-4 when S moves by 1e-7
    relative, at 1 to 3 iterations; the route reads 3.5e-4 here. A gradient
    cut anywhere in the loop misses by far more."""
    gl, S, phase = _griffin_lim()
    S_plain, S_route = S.clone().requires_grad_(), S.clone().requires_grad_()
    want = gl(S_plain, rand_phase=phase)
    weight = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    (want * weight).sum().backward()
    with _kernel_route() as calls:
        got = gl(S_route, rand_phase=phase)
        assert calls == {"framed_pair": 3, "gl_step": 0, "gl_step_fft": 0}
        (got * weight).sum().backward()
    assert _rel(S_route.grad, S_plain.grad) <= 2e-3


def test_a_moved_griffin_lim_keeps_the_route():
    """``Module.to(device)`` puts a new tensor in place of each of the
    transform's own (``_apply(clone)`` does what ``.to`` does to each): the
    new tensors are its own, and K4's FFT route stays, on the same values."""
    gl, S, phase = _griffin_lim(n_iter=2)
    with torch.no_grad(), _kernel_route() as calls:
        want = gl(S, rand_phase=phase)
        old = gl.wcos.data_ptr()
        gl._apply(lambda t: t.clone())
        assert gl.wcos.data_ptr() != old
        got = gl(S, rand_phase=phase)
    assert calls == {"framed_pair": 0, "gl_step": 0, "gl_step_fft": 4}
    assert torch.equal(got, want)


def test_a_basis_passed_in_takes_the_pair_unchecked(plan_builds):
    gl, S, phase = _griffin_lim(n_iter=2)
    with torch.no_grad(), _kernel_route() as calls:
        gl.apply({"wcos": gl.wcos.clone()}, S, rand_phase=phase)
    assert calls == {"framed_pair": 2, "gl_step": 0, "gl_step_fft": 0}
    assert plan_builds == []


def test_inverse_mel_in_fp32_takes_the_route():
    inv = features.InverseMelSpectrogram(sr=16000, n_fft=512, n_mels=40, hop_length=128,
                                         n_iter=4, n_iter_nnls=4, iter_precision="highest",
                                         verbose=False, device="cpu")
    mel = torch.rand(2, 40, 15, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), _kernel_route() as calls:
        inv(mel)
    assert calls == {"framed_pair": 0, "gl_step": 0, "gl_step_fft": 4}


def test_the_k4_routes_are_counted_while_tracing():
    from torch.profiler import ProfilerActivity, profile

    from nnaudio_tpu_torch.utils import profiling

    gl, S, phase = _griffin_lim(n_iter=2)
    x, S1, p_re, p_im = _step_inputs(2, 512, 128, 9)
    with _kernel_route(), torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        gl(S, rand_phase=phase)
        fk.gl_step(x, gl.wcos, gl.wsin, S1, p_re.bfloat16(), p_im.bfloat16(), 128, MOM)
        fk.gl_step(x, gl.wcos.clone(), gl.wsin, S1, p_re, p_im, 128, MOM)
    table = profiling.span_table()
    assert table["nnaudio.route.K4.fft"].count == 2
    assert table["nnaudio.route.K4.dense"].count == 1
    assert table["nnaudio.route.K4.pair"].count == 1
    assert table["nnaudio.wrap.K4"].count == 4
    assert table["nnaudio.route.K4.fft"].outer == table["nnaudio.route.K4.fft"].self_ns == 0


# -------------------------------------------------------------------- card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_kernel_takes_every_n_fft_of_the_route(cuda):
    def takes(n):
        return fk._fft_kernel_takes("nnaudio_gl_step_fft_twiddles", n)
    assert all(takes(n) for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192))
    assert not takes(400) and not takes(16384)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,b,t", [
    (1024, 256, 32, 862),   # the Griffin-Lim cell's step
    (64, 16, 3, 17), (128, 37, 2, 1), (256, 61, 5, 33), (512, 127, 4, 16),
    (2048, 441, 3, 101), (4096, 1001, 2, 9), (8192, 2048, 2, 5), (1024, 1, 1, 40),
])
def test_the_kernel_matches_its_mirror_and_the_pair(cuda, n_fft, hop, b, t):
    _, wc, ws = _basis(n_fft, cuda)
    x, S, p_re, p_im = _step_inputs(b, n_fft, hop, t, seed=hop, device=cuda)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
        twice = fk.gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
        pair = fk.gl_update(*fk.framed_pair(x, wc, ws, hop), S, p_re, p_im, MOM)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["gl_step_fft"] == before["gl_step_fft"] + 2
    assert fk.LAUNCHES["gl_step"] == before["gl_step"]
    assert all(o.shape == (b, n_fft // 2 + 1, t) and o.is_contiguous() for o in got)
    assert all(torch.equal(a, c) for a, c in zip(got, twice))
    mirror = fk.gl_step_fft_plain(x, wc, ws, S, p_re, p_im, hop, MOM)
    r_err, c_err, mag_err = _gl_errors(got, mirror, S, p_re, p_im)
    # c = S n/|n| magnifies r's last bits by up to 100 where |n| >= 1e-2 rms|n|
    assert r_err <= 1e-6 and c_err <= 1e-4 and mag_err <= 1e-6, (r_err, c_err, mag_err)
    r_err, c_err, mag_err = _gl_errors(got, pair, S, p_re, p_im)
    assert r_err <= 1e-5 and c_err <= 1e-4 and mag_err <= 1e-6, (r_err, c_err, mag_err)


@pytest.mark.cuda
def test_a_differentiated_griffin_lim_takes_the_pair_on_the_card(cuda):
    """S requiring grad: every fp32 step takes the pair and the update, and
    the gradient to S is the CPU plain loop's (see the CPU case of this
    name for the gradient's conditioning)."""
    gl, S, phase = _griffin_lim()
    S_cpu = S.clone().requires_grad_()
    want = gl(S_cpu, rand_phase=phase)
    weight = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    (want * weight).sum().backward()
    gl = gl.to(cuda)
    S_card = S.to(cuda).requires_grad_()
    before = dict(fk.LAUNCHES)
    got = gl(S_card, rand_phase=phase.to(cuda))
    torch.cuda.synchronize()
    launched = {k: fk.LAUNCHES[k] - before[k] for k in ("gl_step_fft", "gl_step",
                                                         "framed_pair")}
    assert launched == {"gl_step_fft": 0, "gl_step": 0, "framed_pair": 3}
    (got * weight.to(cuda)).sum().backward()
    assert _rel(S_card.grad, S_cpu.grad) <= 2e-3


@pytest.mark.cuda
def test_inverse_mel_on_the_route_meets_the_pair_and_counts_its_launches(cuda):
    """InverseMelSpectrogram(iter_precision="highest") at the Griffin-Lim
    cell's shapes (32 mels of 862 frames, 32 iterations): n_iter launches of
    the FFT route a call and no pair; the waveform against the same call on
    K5 and the update (the basis passed in)."""
    inv = features.InverseMelSpectrogram(sr=22050, n_fft=1024, hop_length=256, n_mels=80,
                                         fmax=8000.0, power=1.0, iter_precision="highest",
                                         verbose=False, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    mel = torch.rand(32, 80, 862, generator=g, device=cuda) ** 4
    phase = torch.rand(32, 513, 862, generator=g, device=cuda)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = inv(mel, rand_phase=phase)
        torch.cuda.synchronize()
        launched = {k: fk.LAUNCHES[k] - before[k] for k in ("gl_step_fft", "gl_step",
                                                             "framed_pair")}
        want = inv.apply({"wcos": inv.wcos.clone(), "wsin": inv.wsin.clone()}, mel,
                         rand_phase=phase)
    assert launched == {"gl_step_fft": 32, "gl_step": 0, "framed_pair": 0}
    per_clip = [_rel(a, w) for a, w in zip(got, want)]
    assert float(np.median(per_clip)) <= 2e-3, per_clip
