"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one, run ``python -m pytest tests/test_torch_kernels.py -q``;
``python3 chip_smoke.py`` runs the same checks at the slice's full widths,
with the same comparison helpers and tolerances, imported from it here.
"""
import pytest
import torch

from chip_smoke import (CARRY_TOL, MAG_TOL, MOM, TOL, fp64_errors, gl_step_errors,
                        grads_of, pair_grads, rel_err, synthesis_fp64)
from nnaudio_tpu_torch import config
from nnaudio_tpu_torch.core.frame import num_frames
from nnaudio_tpu_torch.ops import dispatch as td
from nnaudio_tpu_torch.ops import framed_kernels as fk

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["highest", "default"])
def mode(request):
    config.set_matmul_precision(request.param)
    yield request.param
    config.set_matmul_precision("highest")


@pytest.mark.parametrize("n_fft,hop,f,m", [
    (1024, 256, 513, 64), (512, 160, 257, 128), (2048, 441, 1025, 256),
    (400, 100, 201, 40), (256, 3, 100, 300),
])
def test_kernels_match_plain_versions(cuda, mode, n_fft, hop, f, m):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, n_fft + 37 * hop + 5, generator=g, device=cuda)
    wc = torch.randn(f, n_fft, generator=g, device=cuda)
    ws = torch.randn(f, n_fft, generator=g, device=cuda)
    fb = torch.rand(m, f, generator=g, device=cuda)
    before = dict(fk.LAUNCHES)
    k1 = fk.framed_magnitude(x, wc, ws, hop, eps=1e-8)
    k2 = fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8)
    sre = torch.randn(2, f, k1.shape[-1], generator=g, device=cuda)
    sim = torch.randn(2, f, k1.shape[-1], generator=g, device=cuda)
    k3 = fk.synthesis_ola(sre, sim, wc, ws, hop)
    torch.cuda.synchronize()
    assert all(fk.LAUNCHES[k] == before[k] + 1
               for k in ("framed_magnitude", "framed_filterbank", "synthesis_ola"))
    assert rel_err(k1, fk.framed_magnitude_plain(x, wc, ws, hop, eps=1e-8)) <= TOL[mode]
    assert rel_err(k2, fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8)) <= TOL[mode]
    assert rel_err(k3, fk.synthesis_ola_plain(sre, sim, wc, ws, hop)) <= TOL[mode]


@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_fft,hop,f", [(1024, 256, 513), (512, 160, 257),
                                         (400, 3, 201)])
def test_gl_step_matches_plain_version(cuda, mode, carry, n_fft, hop, f):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, n_fft + 37 * hop + 5, generator=g, device=cuda)
    wc = torch.randn(f, n_fft, generator=g, device=cuda) / n_fft ** 0.5
    ws = torch.randn(f, n_fft, generator=g, device=cuda) / n_fft ** 0.5
    shape = (2, f, num_frames(x.shape[1], n_fft, hop))
    S = torch.rand(shape, generator=g, device=cuda)
    p_re = torch.randn(shape, generator=g, device=cuda).to(carry)
    p_im = torch.randn(shape, generator=g, device=cuda).to(carry)
    before = fk.LAUNCHES["gl_step"]
    got = fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)  # the tensor-core K4
    torch.cuda.synchronize()
    assert fk.LAUNCHES["gl_step"] == before + 1
    assert all(o.dtype == carry and o.shape == shape for o in got)
    tol = max(TOL[mode], CARRY_TOL[carry])
    r_err, c_err, mag_err, _, _ = gl_step_errors(fk, got, x, wc, ws, S, p_re,
                                                 p_im, hop, MOM)
    assert r_err <= tol and c_err <= tol, (r_err, c_err)
    assert mag_err <= MAG_TOL[carry], mag_err


@pytest.mark.parametrize("n_fft,hop,f", [(1024, 256, 513), (512, 160, 257),
                                         (400, 3, 201)])
def test_pair_and_its_backward_match_plain_autograd(cuda, mode, n_fft, hop, f):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, n_fft + 37 * hop + 5, generator=g, device=cuda)
    wc = torch.randn(f, n_fft, generator=g, device=cuda)
    ws = torch.randn(f, n_fft, generator=g, device=cuda)
    shape = (2, f, num_frames(x.shape[1], n_fft, hop))
    g_re = torch.randn(shape, generator=g, device=cuda)
    g_im = torch.randn(shape, generator=g, device=cuda)

    before = dict(fk.LAUNCHES)
    got = pair_grads(fk.framed_pair, x, wc, ws, hop, g_re, g_im)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["framed_pair"] == before["framed_pair"] + 1
    assert fk.LAUNCHES["synthesis_ola"] == before["synthesis_ola"] + 1  # dx
    want = pair_grads(fk.framed_pair_plain, x, wc, ws, hop, g_re, g_im)
    for name, a, b in zip(("re", "im", "dx", "dwcos", "dwsin"), got, want):
        assert rel_err(a, b) <= TOL[mode], name


@pytest.mark.parametrize("length,n,hop,f,splits", [
    (16384, 8192, 512, 84, None),   # the JAX suite's two K6 cases
    (12000, 4096, 320, 64, None),
    (9000, 5000, 100, 127, None),   # an N that no split divides
    (9000, 5000, 100, 128, 7),
    (30000, 4096, 441, 1, None),
    (4300, 4096, 64, 33, None),     # T below one tile
    (16384, 8192, 512, 84, 1),      # one split: no second pass
])
def test_kchunk_matches_plain_version_and_k1(cuda, mode, length, n, hop, f, splits):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, length, generator=g, device=cuda)
    wc = torch.randn(f, n, generator=g, device=cuda) * 0.05
    ws = torch.randn(f, n, generator=g, device=cuda) * 0.05
    before = dict(fk.LAUNCHES)
    for kw in (dict(eps=1e-8), dict(square=True)):
        k6 = fk.framed_magnitude_kchunk(x, wc, ws, hop, splits=splits, **kw)
        k1 = fk.framed_magnitude(x, wc, ws, hop, **kw)
        torch.cuda.synchronize()
        assert rel_err(k6, fk.framed_magnitude_plain(x, wc, ws, hop, **kw)) <= TOL[mode]
        # K1 and K6 sum in other orders (K6 by bin group and split)
        assert rel_err(k6, k1) <= TOL[mode]
        # no atomics: a second launch gives the same bits
        assert torch.equal(k6, fk.framed_magnitude_kchunk(x, wc, ws, hop, splits=splits, **kw))
    assert fk.LAUNCHES["framed_magnitude_kchunk"] == before["framed_magnitude_kchunk"] + 4
    assert fk.LAUNCHES["framed_magnitude"] == before["framed_magnitude"] + 2


def _banded_bank(f, n, cuda, seed, zero_group=None):
    """A bank shaped like the CQT's: row i nonzero on a centred window that
    narrows from most of n to a few samples, zero elsewhere; with
    ``zero_group`` that group of KCHUNK_GROUP rows all zero."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = [torch.randn(f, n, generator=g, device=cuda) * 0.05 for _ in range(2)]
    half = torch.linspace(0.45 * n, 8, f, device=cuda).long()
    k = torch.arange(n, device=cuda)
    inside = (k[None] >= n // 2 - half[:, None]) & (k[None] < n // 2 + half[:, None])
    if zero_group is not None:
        rows = slice(zero_group * fk.KCHUNK_GROUP, (zero_group + 1) * fk.KCHUNK_GROUP)
        inside[rows] = False
    return [a * inside for a in w]


def _k6_bank(case, cuda):
    """(wcos, wsin) of a banded K6 case."""
    from nnaudio_tpu_torch.features import CQT1992v2

    kind, f, n = case
    if kind in ("cqt", "edited"):
        cqt = CQT1992v2(sr=16000, hop_length=256, fmin=100, n_bins=f, verbose=False,
                        device=cuda)
        wc, ws = cqt.cqt_kernels_real.clone(), cqt.cqt_kernels_imag.clone()
        if kind == "edited":
            wc[-1, 0] = 0.25  # far outside the top bin's atom
        return wc, ws
    return _banded_bank(f, n, cuda, 11, zero_group=1 if kind == "zero group" else None)


@pytest.mark.parametrize("case,length,hop", [
    (("cqt", 36, None), 4096 + 256 * 40, 256),       # a small CQT1992v2 bank
    (("edited", 36, None), 4096 + 256 * 40, 256),    # one entry set outside the atoms
    (("zero group", 3 * fk.KCHUNK_GROUP, 4096), 4096 + 256 * 30, 256),  # middle group 0
    (("cqt", 36, None), 4096 + 441 * 30, 441),       # hop 441
    (("banded", 40, 1024), 1024 + 3 * 500, 3),       # hop 3
    (("banded", 84, 5000), 5000 + 100 * 60, 100),    # N not a multiple of a K chunk
    (("banded", 60, 4093), 4093 + 64 * 50, 64),      # rows off 16 bytes (N % 4 != 0)
    (("banded", 1, 4096), 4096 + 512 * 20, 512),     # F = 1
    (("banded", 128, 4096), 4096 + 512 * 20, 512),   # F = 128
])
def test_kchunk_on_banded_banks(cuda, mode, case, length, hop):
    """K6 on banks whose groups have their own ranges: against the plain
    version and K1, bit-equal twice, its ranges equal the plain ones', and
    in fp32 storage against the banded 3xTF32 twin."""
    wc, ws = _k6_bank(case, cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, length, generator=g, device=cuda)
    before = dict(fk.LAUNCHES)
    for kw in (dict(eps=1e-8), dict(square=True)):
        k6 = fk.framed_magnitude_kchunk(x, wc, ws, hop, **kw)
        k1 = fk.framed_magnitude(x, wc, ws, hop, **kw)
        torch.cuda.synchronize()
        assert rel_err(k6, fk.framed_magnitude_plain(x, wc, ws, hop, **kw)) <= TOL[mode]
        assert rel_err(k6, k1) <= TOL[mode]
        assert torch.equal(k6, fk.framed_magnitude_kchunk(x, wc, ws, hop, **kw))
        if mode == "highest":
            twin = fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, hop, **kw)
            assert rel_err(k6, twin) <= TOL[mode]
    assert fk.LAUNCHES["framed_magnitude_kchunk"] == before["framed_magnitude_kchunk"] + 4
    storage = config.storage_dtype()
    want = fk.kchunk_ranges_plain(wc.to(storage), ws.to(storage))
    assert torch.equal(fk.kchunk_ranges(wc, ws).cpu(), want.cpu())


def test_kchunk_zero_group_gives_sqrt_eps(cuda):
    wc, ws = _banded_bank(3 * fk.KCHUNK_GROUP, 4096, cuda, 13, zero_group=1)
    x = torch.randn(2, 4096 + 256 * 30, device=cuda)
    rows = slice(fk.KCHUNK_GROUP, 2 * fk.KCHUNK_GROUP)
    mag = fk.framed_magnitude_kchunk(x, wc, ws, 256, eps=1e-8)
    power = fk.framed_magnitude_kchunk(x, wc, ws, 256, square=True)
    assert torch.equal(mag[:, rows], torch.full_like(mag[:, rows], 1e-8).sqrt())
    assert torch.equal(power[:, rows], torch.zeros_like(power[:, rows]))


def test_kchunk_fp32_is_as_accurate_as_the_fp32_product(cuda):
    """Against the fp64 magnitude, K6 in fp32 storage errs at most 4x as
    much as the plain fp32 version, on the default CQT1992v2 bank."""
    from nnaudio_tpu_torch.features import CQT1992v2

    cqt = CQT1992v2(verbose=False, device=cuda)
    wc, ws = cqt.cqt_kernels_real, cqt.cqt_kernels_imag
    n = wc.shape[1]
    x = torch.randn(2, n + 512 * 60, device=cuda)
    frames = x.double().unfold(-1, n, 512)
    ref = torch.hypot(torch.einsum("fn,btn->bft", wc.double(), frames),
                      torch.einsum("fn,btn->bft", ws.double(), frames))
    config.set_matmul_precision("highest")
    got = fk.framed_magnitude_kchunk(x, wc, ws, 512)
    plain = fk.framed_magnitude_plain(x, wc, ws, 512)
    assert rel_err(got, ref) <= 4 * rel_err(plain, ref)


def test_kchunk_skips_samples_outside_every_range(cuda):
    """The documented difference: a NaN in a sample that meets only bank
    columns outside every group's range is never multiplied."""
    wc, ws = _banded_bank(32, 4096, cuda, 14)
    lo = int(fk.kchunk_ranges_plain(wc, ws)[:, 0].min())
    assert lo >= 2 * fk.KCHUNK_BK[torch.bfloat16]
    x = torch.randn(1, 4096 + 512 * 10, device=cuda)
    x[0, 0] = float("nan")  # column 0 of frame 0 only
    assert torch.isfinite(fk.framed_magnitude_kchunk(x, wc, ws, 512)).all()
    assert torch.isnan(fk.framed_magnitude_plain(x, wc, ws, 512)).any()


@pytest.mark.parametrize("length,n,hop,f", [
    (2048 + 2 * 512, 2048, 512, 1025),   # T = 3, below one frame tile
    (30000, 2048, 512, 1),               # one bin
    (20000, 256, 64, 12),                # an octave of the pyramid
    (16384 + 512 * 20, 16384, 512, 84),  # the default CQT bank
    (8192 + 128 * 300, 8192, 128, 48),   # the CQT round trip's bank
    (9000, 5000, 100, 84),               # an N no K chunk divides
    (66151, 2048, 441, 300),             # odd length, odd hop
    (3001, 250, 7, 33),                  # basis rows off 16 bytes
    (3002, 250, 6, 33),                  # frame rows aligned to 4 bytes only (bf16)
    (222548, 2048, 512, 1025),           # the STFT 2048/512 of a 10 s clip
])
def test_tensor_core_kernels_match_plain_versions_twice(cuda, mode, length, n, hop, f):
    """K1 and K5 at shapes off their tiles, and a second launch bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, length, generator=g, device=cuda)
    wc = torch.randn(f, n, generator=g, device=cuda) * 0.05
    ws = torch.randn(f, n, generator=g, device=cuda) * 0.05
    pair = fk.framed_pair(x, wc, ws, hop)
    torch.cuda.synchronize()
    for got, want in zip(pair, fk.framed_pair_plain(x, wc, ws, hop)):
        assert rel_err(got, want) <= TOL[mode]
    for got, again in zip(pair, fk.framed_pair(x, wc, ws, hop)):
        assert torch.equal(got, again)
    for kw in (dict(eps=1e-8), dict(square=True)):
        k1 = fk.framed_magnitude(x, wc, ws, hop, **kw)
        torch.cuda.synchronize()
        assert rel_err(k1, fk.framed_magnitude_plain(x, wc, ws, hop, **kw)) <= TOL[mode]
        assert torch.equal(k1, fk.framed_magnitude(x, wc, ws, hop, **kw))


def test_3xtf32_pair_is_as_accurate_as_the_fp32_product(cuda):
    """Against an fp64 product the kernel's fp32-storage result errs at most
    4x as much as the plain fp32 version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n, hop, f = 2048, 512, 1025
    x = torch.randn(2, n + 100 * hop, generator=g, device=cuda)
    wc = torch.randn(f, n, generator=g, device=cuda) * 0.05
    ref = torch.einsum("fn,btn->bft", wc.double(), x.double().unfold(-1, n, hop))
    config.set_matmul_precision("highest")
    got = fk.framed_pair(x, wc, wc, hop)[0]
    plain = fk.framed_pair_plain(x, wc, wc, hop)[0]
    assert rel_err(got, ref) <= 4 * rel_err(plain, ref)


@pytest.mark.parametrize("length,n,hop,f,m", [
    (16000 + 1024, 1024, 256, 513, 64),  # the classifier's front end, 1 s
    (30000, 2048, 512, 1, 1),            # one bin, one mel
    (2048 + 2 * 512, 2048, 512, 1025, 128),  # T = 3, below one frame tile
    (4000, 400, 3, 201, 300),            # hop 3, five m-tiles of mels
    (66151, 2048, 441, 1025, 256),       # odd length, hop 441
    (9000, 5000, 100, 84, 40),           # an N no K chunk divides
])
def test_filterbank_and_gl_step_on_the_tensor_cores_twice(cuda, mode, length, n, hop, f, m):
    """K2 and K4 (both carry types) at shapes off the tiles of the
    tensor-core loop, against their plain versions, and a second launch
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, length, generator=g, device=cuda)
    wc = torch.randn(f, n, generator=g, device=cuda) * 0.05
    ws = torch.randn(f, n, generator=g, device=cuda) * 0.05
    fb = torch.rand(m, f, generator=g, device=cuda)
    k2 = fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8)
    torch.cuda.synchronize()
    assert k2.shape == (2, m, num_frames(length, n, hop))
    assert rel_err(k2, fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8)) <= TOL[mode]
    assert torch.equal(k2, fk.framed_filterbank(x, wc, ws, fb, hop, eps=1e-8))
    shape = (2, f, num_frames(length, n, hop))
    S = torch.rand(shape, generator=g, device=cuda)
    for carry in (torch.float32, torch.bfloat16):
        p_re = torch.randn(shape, generator=g, device=cuda).to(carry)
        p_im = torch.randn(shape, generator=g, device=cuda).to(carry)
        got = fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)
        torch.cuda.synchronize()
        tol = max(TOL[mode], CARRY_TOL[carry])
        r_err, c_err, mag_err, _, _ = gl_step_errors(fk, got, x, wc, ws, S, p_re,
                                                     p_im, hop, MOM)
        assert r_err <= tol and c_err <= tol, (r_err, c_err)
        assert mag_err <= MAG_TOL[carry], mag_err
        for a, b in zip(got, fk._launch_gl_step(x, wc, ws, S, p_re, p_im, hop, MOM)):
            assert torch.equal(a, b)


def test_3xtf32_filterbank_and_gl_step_are_as_accurate_as_fp32(cuda):
    """Against fp64 versions of the same functions, K2 and K4 in fp32
    storage err at most 4x as much as their plain fp32 versions."""
    g = torch.Generator(device=cuda).manual_seed(7)
    n, hop, f, m = 1024, 256, 513, 64
    x = torch.randn(2, n + 200 * hop, generator=g, device=cuda)
    wc = torch.randn(f, n, generator=g, device=cuda) * 0.05
    ws = torch.randn(f, n, generator=g, device=cuda) * 0.05
    fb = torch.rand(m, f, generator=g, device=cuda)
    shape = (2, f, 201)
    S = torch.rand(shape, generator=g, device=cuda)
    p_re = torch.randn(shape, generator=g, device=cuda)
    p_im = torch.randn(shape, generator=g, device=cuda)
    config.set_matmul_precision("highest")
    for name, (kernel, plain) in fp64_errors(fk, x, wc, ws, fb, S, p_re, p_im,
                                             hop, MOM).items():
        assert kernel <= 4 * plain, (name, kernel, plain)


def test_kchunk_rejects_wide_banks(cuda):
    x = torch.randn(1, 8192, device=cuda)
    w = torch.randn(129, 4096, device=cuda)
    with pytest.raises(ValueError, match="at most 128 bins"):
        fk.framed_magnitude_kchunk(x, w, w, 64)


@pytest.mark.parametrize("b,f,t,n,hop", [
    (2, 1025, 40, 2048, 512), (2, 1025, 30, 2048, 441), (2, 513, 50, 1024, 256),
    (2, 257, 60, 512, 128), (2, 201, 90, 400, 3),
    (2, 84, 60, 16384, 128),  # the flat CQT inverse's bank
])
def test_synthesis_on_the_tensor_cores_matches_both_plain_versions(cuda, mode, b, f, t, n, hop):
    """K3 against the plain version and, in fp32 storage, its 3xTF32 twin
    and fp64 (within 4x the plain fp32 version's error); a second launch
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(8)
    sre = torch.randn(b, f, t, generator=g, device=cuda)
    sim = torch.randn(b, f, t, generator=g, device=cuda)
    kc = torch.randn(f, n, generator=g, device=cuda) / n
    ks = torch.randn(f, n, generator=g, device=cuda) / n
    before = fk.LAUNCHES["synthesis_ola"]
    got = fk.synthesis_ola(sre, sim, kc, ks, hop)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["synthesis_ola"] == before + 1
    assert got.shape == (b, n + hop * (t - 1))
    plain = fk.synthesis_ola_plain(sre, sim, kc, ks, hop)
    assert rel_err(got, plain) <= TOL[mode]
    assert torch.equal(got, fk.synthesis_ola(sre, sim, kc, ks, hop))
    if mode == "highest":
        assert rel_err(got, fk.synthesis_ola_3xtf32_plain(sre, sim, kc, ks, hop)) <= TOL[mode]
        ref = synthesis_fp64(sre, sim, kc, ks, hop)
        assert rel_err(got, ref) <= 4 * rel_err(plain, ref)


def _route_case(op, cuda):
    """(loss of the leaves, leaves) of one framed op on the card: K1 at
    257 x 512, K6's envelope at 65 x 4096 (K1's function), K2, K3."""
    g = torch.Generator(device=cuda).manual_seed(9)
    n = 4096 if op == "K6" else 512
    x = torch.randn(2, n + 64 * 20 + 3, generator=g, device=cuda)
    w = [torch.randn(65 if op == "K6" else 257, n, generator=g, device=cuda) * 0.05
         for _ in range(2)]
    if op in ("K1", "K6"):
        assert td.kchunk_envelope(*w[0].shape) == (op == "K6")
        return lambda x, wc, ws: td.framed_magnitude(x, wc, ws, 64, eps=1e-8).sum(), [x, *w]
    if op == "K2":
        fb = torch.rand(40, 257, generator=g, device=cuda)
        return (lambda x, wc, ws, fb: (td.framed_filterbank(x, wc, ws, fb, 64, eps=1e-8)
                                       ** 2).mean(), [x, *w, fb])
    spec = [torch.randn(2, 257, 21, generator=g, device=cuda) for _ in range(2)]
    target = torch.randn(2, 512 + 64 * 20, generator=g, device=cuda)
    return (lambda sre, sim, kc, ks: ((td.synthesis_ola(sre, sim, kc, ks, 64) - target)
                                      ** 2).sum(), [*spec, *w])


@pytest.mark.parametrize("op", ["K1", "K2", "K3", "K6"])
def test_kernel_route_gradients_match_plain_route(cuda, mode, op):
    """The gradients of every input of K1, K2, K3 and K6 on the kernel route
    (the pair, K5, in the forward of K1, K2 and K6; K3 and its backward)
    against the plain route's; the differentiated forwards launch no K1, K2
    or K6."""
    loss_fn, leaves = _route_case(op, cuda)
    before = dict(fk.LAUNCHES)
    loss, grads = grads_of(loss_fn, leaves)
    torch.cuda.synchronize()
    launched = {k: fk.LAUNCHES[k] - before[k] for k in before}
    assert launched["framed_magnitude"] == launched["framed_filterbank"] == 0
    assert launched["framed_magnitude_kchunk"] == launched["framed_filterbank_fft"] == 0
    # K3 forward and dx; K5 forward, and the spectra's gradient of K3
    assert launched["framed_pair"] == 1 and launched["synthesis_ola"] == 1
    config.set_use_kernels(False)
    try:
        want_loss, want = grads_of(loss_fn, leaves)
    finally:
        config.set_use_kernels(True)
    assert rel_err(loss, want_loss) <= TOL[mode]
    for got, ref in zip(grads, want):
        assert torch.isfinite(got).all() and rel_err(got, ref) <= TOL[mode]


def test_only_the_gl_step_backward_raises(cuda):
    x = torch.randn(1, 4096, device=cuda)
    w = torch.randn(65, 512, device=cuda, requires_grad=True)
    t = num_frames(4096, 512, 64)
    S = torch.rand(1, 65, t, device=cuda)
    # bf16 carries: the tensor-core K4 (fp32 carries would take the pair)
    p_re, p_im = (torch.rand(1, 65, t, device=cuda).bfloat16() for _ in range(2))
    out = fk.gl_step(x, w, w, S, p_re, p_im, 64, MOM)[0]
    with pytest.raises(NotImplementedError, match="no gradient"):
        out.sum().backward()
