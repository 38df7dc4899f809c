"""The inverse Mel's NNLS kernel: the plain mirror of its arithmetic (against
the dense products and the JAX package's ``mel_to_power``), its plan, and the
route each call takes; then, marked ``cuda`` (skipped without a card), the
kernel itself.

The cases marked ``cuda`` run on the card with
``python -m pytest tests/test_torch_nnls_banded.py -q --noconftest -m cuda``;
the one case that compares with the JAX package imports it inside the test.
"""
import contextlib

import numpy as np
import pytest
import torch

from nnaudio_tpu_torch import config, features
from nnaudio_tpu_torch.ops import dispatch as td
from nnaudio_tpu_torch.ops import framed_kernels as fk

#: the inversion cell's basis (Tacotron 2's 80 mels to 8 kHz), a 128-mel
#: basis at n_fft 2048 over the whole band, and an HTK basis
BASES = {"cell 5": dict(sr=22050, n_fft=1024, n_mels=80, fmax=8000.0),
         "n_fft 2048, 128 mels": dict(sr=22050, n_fft=2048, n_mels=128),
         "htk": dict(sr=16000, n_fft=512, n_mels=40, htk=True)}


def _rel(got, want):
    """max |got - want| / max |want|, in float64."""
    got, want = (torch.as_tensor(np.array(a.detach().cpu() if isinstance(a, torch.Tensor)
                                          else a)).double() for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def _inverse(basis="cell 5", device="cpu", **kw):
    return features.InverseMelSpectrogram(hop_length=256, verbose=False, device=device,
                                          **{**BASES[basis], **kw})


def _mels(inv, b=2, t=21, seed=0, device="cpu"):
    """Mels of peaky nonnegative spectra (B, F, T) through the basis: the
    NNLS has a nonnegative solution to find, and its bounds bind."""
    g = torch.Generator(device=device).manual_seed(seed)
    spectra = torch.rand(b, inv.mel_basis.shape[1], t, generator=g, device=device) ** 4
    return torch.einsum("mf,bft->bmt", inv.mel_basis, spectra)


def _nnls(fn, inv, mel, n_iter):
    return fn(inv.mel_basis, inv.mel_pinv, mel, inv._step, n_iter)


@contextlib.contextmanager
def _kernel_route():
    """The NNLS wrapper takes the branch of a CUDA tensor; its launcher
    computes the mirror, and is counted."""
    calls = {"nnls_banded": 0}

    def launch(*args):
        calls["nnls_banded"] += 1
        return fk.nnls_banded_plain(*args[:-1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "_on_card", lambda t: True)
        mp.setattr(fk, "_launch_nnls", launch)
        mp.setattr(fk, "_launch_gl_step_fft", lambda *args: fk.gl_step_fft_plain(*args[:-1]))
        mp.setattr(fk, "_launch_synthesis_fft", lambda sre, sim, hop, plan:
                   fk.synthesis_ola_fft_plain(sre, sim, plan.scale, hop))
        yield calls


# ---------------------------------------------------------------- the mirror --
@pytest.mark.parametrize("basis", list(BASES))
def test_the_mirror_meets_the_products_and_jax(basis):
    """nnls_banded_plain against the dense products of the plain route and
    against the JAX package's mel_to_power, at 64 steps (the cell's count)."""
    from nnaudio_tpu import features as jf

    inv = _inverse(basis, n_iter_nnls=64)
    mel = _mels(inv)
    got = _nnls(fk.nnls_banded_plain, inv, mel, 64)
    assert got.shape == (2, inv.mel_basis.shape[1], 21) and got.dtype == torch.float32
    assert bool((got >= 0).all())
    assert _rel(got, _nnls(fk.nnls_plain, inv, mel, 64)) <= 1e-5
    jinv = jf.InverseMelSpectrogram(hop_length=256, n_iter_nnls=64, verbose=False,
                                    **BASES[basis])
    assert jinv._step == inv._step
    want = jinv.mel_to_power(dict(jinv._params), mel.numpy())
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("n_iter", [0, 1, 64])
def test_the_step_count_is_honoured(n_iter):
    """n steps of the mirror meet n steps of the products, and miss n - 1 and
    n + 1 of them by far more; no step leaves the seed, relu(pinv(M) mel)."""
    inv = _inverse()
    mel = _mels(inv, seed=n_iter)
    got = _nnls(fk.nnls_banded_plain, inv, mel, n_iter)
    assert _rel(got, _nnls(fk.nnls_plain, inv, mel, n_iter)) <= 1e-5
    assert _rel(got, _nnls(fk.nnls_plain, inv, mel, n_iter + 1)) >= 1e-3
    if n_iter:
        assert _rel(got, _nnls(fk.nnls_plain, inv, mel, n_iter - 1)) >= 1e-3
    else:
        seed = torch.relu(torch.einsum("fm,bmt->bft", inv.mel_pinv, mel))
        assert _rel(got, seed) <= 1e-6


def test_a_transforms_mel_to_power_is_the_ops_layers_nnls():
    inv = _inverse(n_iter_nnls=5)
    mel = _mels(inv)
    got = inv.mel_to_power(inv.params, mel)
    assert torch.equal(got, _nnls(fk.nnls_plain, inv, mel, 5))
    assert torch.equal(td.nnls(inv.mel_basis, inv.mel_pinv, mel, inv._step, 5), got)


# ---------------------------------------------------------------------- plan --
@pytest.mark.parametrize("basis", list(BASES))
def test_the_plan_holds_both_bands_of_the_basis(basis):
    """The plan's rows and bins are filterbank_bands of M and of M^T over the
    active bins, whose block fits; the cell's block is 70,760 bytes. A mel
    basis's bins have at most two rows (the wide-bin header is checked on
    a banded basis of three rows a bin)."""
    inv = _inverse(basis)
    m_, f_ = inv.mel_basis.shape
    plan = fk.build_nnls_plan(inv.mel_basis, inv.mel_pinv)
    assert plan is not None and torch.equal(plan.pinv_t, inv.mel_pinv.t())
    lo, off, vals = fk.filterbank_bands(inv.mel_basis)
    rows = plan.band[:m_].long()
    length = off[1:] - off[:-1]
    assert torch.equal(rows[:, 1], length) and torch.equal(rows[:, 2], off[:-1])
    assert torch.equal((rows[:, 0] + plan.fa)[length > 0], lo[length > 0])
    assert torch.equal(plan.vals[:plan.nnz_rows], vals)
    clo, coff, cvals = fk.filterbank_bands(inv.mel_basis.t())
    clen = coff[1:] - coff[:-1]
    active = torch.nonzero(clen).flatten()
    assert (plan.fa, plan.nf) == (int(active[0]), int(active[-1]) + 1 - int(active[0]))
    bins = plan.band[m_:].long()
    assert torch.equal(bins[:, 1], clen[plan.fa:plan.fa + plan.nf])
    assert torch.equal(plan.vals[plan.nnz_rows:], cvals)
    # a bin of at most two rows holds its entries' bits in its header, 0 past
    # its length; a wider one the offset of its entries
    short = bins[:, 1] <= 2
    held = plan.band[m_:, 2:].contiguous().view(torch.float32)[short]
    start = coff[plan.fa:plan.fa + plan.nf][short]
    lens = bins[short, 1]
    padded = torch.cat((cvals, torch.zeros(2)))
    assert torch.equal(held[:, 0], torch.where(lens > 0, padded[start], 0.0))
    assert torch.equal(held[:, 1], torch.where(lens > 1, padded[start + 1], 0.0))
    assert torch.equal(bins[~short, 2], coff[plan.fa:plan.fa + plan.nf][~short])
    nbytes = fk.nnls_block_bytes(plan.nf, m_, plan.vals.numel())
    assert nbytes <= fk.SMEM_LIMIT
    if basis == "cell 5":
        assert (plan.fa, plan.nf, plan.nnz_rows, nbytes) == (1, 371, 727, 70_760)


def _three_row_basis(device="cpu"):
    """A banded basis (12, 42) whose bins meet up to three rows, marked as a
    transform's own, and its pseudo-inverse."""
    basis = torch.zeros(12, 42)
    for m in range(12):
        basis[m, 3 * m:3 * m + 9] = torch.rand(9, generator=torch.Generator().manual_seed(m))
    pinv = torch.linalg.pinv(basis.double()).float()
    basis, pinv = basis.to(device), pinv.to(device)
    fk.mark_own(basis, pinv)
    return basis, pinv


def test_a_bin_of_three_rows_keeps_its_entries_apart():
    """A banded basis whose bins each meet up to three rows: those bins'
    headers hold the offset of their entries, and the mirror still meets the
    products."""
    basis, pinv = _three_row_basis()
    m_, f_ = basis.shape
    plan = fk.build_nnls_plan(basis, pinv)
    bins = plan.band[m_:].long()
    assert int(bins[:, 1].max()) == 3 and bool((bins[bins[:, 1] > 2, 3] == 0).all())
    mel = torch.einsum("mf,bft->bmt", basis, torch.rand(2, f_, 7) ** 4)
    got = fk.nnls_banded_plain(basis, pinv, mel, 0.05, 16)
    assert _rel(got, fk.nnls_plain(basis, pinv, mel, 0.05, 16)) <= 1e-5


def test_the_plan_is_kept_until_the_basis_changes(monkeypatch):
    built = []
    real = fk.build_nnls_plan
    monkeypatch.setattr(fk, "build_nnls_plan", lambda *ops: built.append(real(*ops)) or built[-1])
    monkeypatch.setattr(fk, "_on_card", lambda t: True)
    inv = _inverse()
    mel = _mels(inv)
    first = fk.nnls_plan(inv.mel_basis, inv.mel_pinv, mel)
    assert first is not None and fk.nnls_plan(inv.mel_basis, inv.mel_pinv, mel) is first
    with torch.no_grad():
        inv.mel_basis[3, 7] += 0.5
    again = fk.nnls_plan(inv.mel_basis, inv.mel_pinv, mel)
    assert again is not first and len(built) == 2
    assert float(again.vals[:again.nnz_rows].sum()) == pytest.approx(
        float(inv.mel_basis.sum()), rel=1e-6)


# -------------------------------------------------------------------- routes --
ROUTES = [("own fp32 basis", "fused"), ("mel requires grad", "plain"),
          ("bf16 storage", "plain"), ("unmarked copy", "plain"), ("F too large", "plain")]


@pytest.mark.parametrize("case,route", ROUTES)
def test_each_call_takes_its_route(case, route):
    """The ops layer's one decision: the kernel for the transform's own fp32
    basis outside autograd, in fp32 storage, where the block fits; the dense
    products for every other call, whose gradient reaches the mels."""
    inv = _inverse("n_fft 2048, 128 mels", n_fft=4096) if case == "F too large" else _inverse()
    mel = _mels(inv, t=9)
    basis, pinv = inv.mel_basis, inv.mel_pinv
    if case == "unmarked copy":
        basis, pinv = basis.clone(), pinv.clone()
    if case == "mel requires grad":
        mel = mel.requires_grad_()
    if case == "F too large":
        plan = fk.build_nnls_plan(basis, pinv)
        assert plan is None
    mode = "default" if case == "bf16 storage" else "highest"
    config.set_matmul_precision(mode)
    try:
        with _kernel_route() as calls:
            got = fk.nnls(basis, pinv, mel, inv._step, 8)
            want = fk.nnls_plain(basis, pinv, mel, inv._step, 8)
    finally:
        config.set_matmul_precision("highest")
    assert calls == {"nnls_banded": int(route == "fused")}
    assert _rel(got, want) <= (1e-5 if route == "fused" else 0.0)
    if case == "mel requires grad":
        weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
        (g_route,) = torch.autograd.grad((got * weight).sum(), mel)
        mel_plain = mel.detach().clone().requires_grad_()
        plain = fk.nnls_plain(basis, pinv, mel_plain, inv._step, 8)
        (g_plain,) = torch.autograd.grad((plain * weight).sum(), mel_plain)
        assert torch.isfinite(g_route).all() and float(g_route.abs().max()) > 0
        assert torch.equal(g_route, g_plain)


def test_inverse_mel_and_mfcc_take_the_kernel_once_a_call():
    inv = _inverse(n_iter=2, n_iter_nnls=6, iter_precision="highest")
    mel = _mels(inv, t=12)
    phase = torch.rand(2, 513, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = inv(mel, rand_phase=phase)
        with _kernel_route() as calls:
            got = inv(mel, rand_phase=phase)
    assert calls == {"nnls_banded": 1}
    assert _rel(got, want) <= 1e-4
    mfcc = features.InverseMFCC(n_mfcc=20, n_iter=1, n_iter_nnls=4, iter_precision="highest",
                                verbose=False, device="cpu", hop_length=256, **BASES["cell 5"])
    coeffs = torch.randn(2, 20, 12, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), _kernel_route() as calls:
        mfcc(coeffs, rand_phase=phase)
    assert calls == {"nnls_banded": 1}


def test_the_nnls_routes_are_counted_while_tracing():
    from torch.profiler import ProfilerActivity, profile

    from nnaudio_tpu_torch.utils import profiling

    inv = _inverse()
    mel = _mels(inv, t=5)
    with _kernel_route(), torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        fk.nnls(inv.mel_basis, inv.mel_pinv, mel, inv._step, 2)
        fk.nnls(inv.mel_basis, inv.mel_pinv, mel, inv._step, 2)
        fk.nnls(inv.mel_basis.clone(), inv.mel_pinv, mel, inv._step, 2)
    table = profiling.span_table()
    assert table["nnaudio.route.NNLS.fused"].count == 2
    assert table["nnaudio.route.NNLS.plain"].count == 1
    assert table["nnaudio.wrap.NNLS"].count == 3


# -------------------------------------------------------------------- card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_kernel_takes_the_cells_block_and_refuses_an_oversized_one(cuda):
    assert fk._nnls_kernel_takes(371, 80, 1454)
    assert not fk._nnls_kernel_takes(2048, 128, 8000)
    assert not fk._nnls_kernel_takes(10, 129, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("basis,b,t,n_iter,layout", [
    ("cell 5", 32, 862, 64, "contiguous"),   # the inversion cell's call; 862 = 26 x 32 + 30
    ("cell 5", 32, 862, 63, "transposed"),   # a step fewer, mels read through a copy
    ("cell 5", 3, 1, 64, "contiguous"), ("cell 5", 2, 33, 0, "contiguous"),
    ("n_fft 2048, 128 mels", 4, 97, 64, "contiguous"), ("htk", 5, 40, 17, "transposed"),
])
def test_the_kernel_matches_its_mirror_and_the_products(cuda, basis, b, t, n_iter, layout):
    inv = _inverse(basis, device=cuda)
    mel = _mels(inv, b=b, t=t, seed=t, device=cuda)
    if layout == "transposed":
        mel = mel.transpose(1, 2).contiguous().transpose(1, 2)
        assert not mel.is_contiguous()
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = _nnls(fk.nnls, inv, mel, n_iter)
        twice = _nnls(fk.nnls, inv, mel, n_iter)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["nnls_banded"] == before["nnls_banded"] + 2
    assert got.shape == (b, inv.mel_basis.shape[1], t) and got.is_contiguous()
    assert torch.equal(got, twice)
    assert _rel(got, _nnls(fk.nnls_banded_plain, inv, mel, n_iter)) <= 1e-5
    assert _rel(got, _nnls(fk.nnls_plain, inv, mel, n_iter)) <= 1e-5
    if n_iter:
        assert _rel(got, _nnls(fk.nnls_plain, inv, mel, n_iter - 1)) >= 1e-3


@pytest.mark.cuda
def test_inverse_mel_on_the_card_launches_the_kernel_and_no_product(cuda):
    """An fp32 InverseMelSpectrogram call: one NNLS launch, no cuBLAS
    product in its trace; under grad the products, with a gradient."""
    from torch.profiler import ProfilerActivity, profile

    inv = _inverse(device=cuda, n_iter=2, iter_precision="highest")
    mel = _mels(inv, b=4, t=50, device=cuda)
    fk.reset_launches()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        inv(mel)
        torch.cuda.synchronize()
    assert fk.LAUNCHES["nnls_banded"] == 1
    names = [e.key for e in prof.key_averages()]
    assert any("nnls_banded_kernel" in n for n in names)
    assert not any("gemm" in n for n in names), names
    fk.reset_launches()
    mel = mel.requires_grad_()
    inv.mel_to_power(inv.params, mel).sum().backward()
    assert fk.LAUNCHES["nnls_banded"] == 0 and torch.isfinite(mel.grad).all()


@pytest.mark.cuda
def test_the_kernel_reads_a_bin_of_three_rows_from_its_entries(cuda):
    basis, pinv = _three_row_basis(cuda)
    mel = torch.einsum("mf,bft->bmt", basis,
                       torch.rand(3, 42, 70, generator=torch.Generator(device=cuda).manual_seed(5),
                                  device=cuda) ** 4)
    before = fk.LAUNCHES["nnls_banded"]
    with torch.no_grad():
        got = fk.nnls(basis, pinv, mel, 0.05, 16)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["nnls_banded"] == before + 1
    assert _rel(got, fk.nnls_banded_plain(basis, pinv, mel, 0.05, 16)) <= 1e-5
    assert _rel(got, fk.nnls_plain(basis, pinv, mel, 0.05, 16)) <= 1e-5
