"""K6's banded arithmetic on the CPU: the bank ranges its pre-pass finds
(:func:`kchunk_ranges_plain`), the banded 3xTF32 twin of its main loop
(:func:`framed_magnitude_banded_3xtf32_plain`) against the plain version and
the JAX package's interpreted K-chunked kernel, and the workspace it asks
for. The kernel itself is held against these on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu.ops import framed_matmul
from nnaudio_tpu_torch.features import CQT1992v2
from nnaudio_tpu_torch.filters.windows import window_dispatch
from nnaudio_tpu_torch.ops import framed_kernels as fk

TOL = 1e-4  # tests/test_ops.py's framed-op tolerance
G = fk.KCHUNK_GROUP


def _rel(got, want):
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _banded(f, n, seed, zero_group=None):
    """A CQT-shaped bank: row i nonzero on a centred window narrowing from
    most of n to a few samples; with ``zero_group`` that group all zero."""
    rng = np.random.RandomState(seed)
    w = [(rng.randn(f, n) * 0.05).astype(np.float32) for _ in range(2)]
    half = np.linspace(0.45 * n, 8, f).astype(int)
    k = np.arange(n)
    inside = (k[None] >= n // 2 - half[:, None]) & (k[None] < n // 2 + half[:, None])
    if zero_group is not None:
        inside[zero_group * G:(zero_group + 1) * G] = False
    return [torch.from_numpy(a * inside) for a in w]


@pytest.fixture(scope="module")
def cqt_bank():
    return CQT1992v2(verbose=False, device="cpu")


def test_ranges_of_the_default_cqt_bank_follow_its_lengths(cqt_bank):
    """Each group's range is the union of its wavelets' spans, as
    ``filters/cqt.py`` centres them (odd lengths one sample left), less the
    first sample, where the periodic Hann window is exactly zero."""
    n = cqt_bank.kernel_width
    lengths = cqt_bank.lenghts.numpy().astype(int)
    start = np.where(lengths % 2 == 1, np.ceil(n / 2 - lengths / 2) - 1,
                     np.ceil(n / 2 - lengths / 2)).astype(int)
    first = np.array([np.flatnonzero(window_dispatch("hann", int(l), fftbins=True))[0]
                      for l in lengths])
    lo, hi = start + first, start + lengths
    groups = -(-len(lengths) // G)
    want = [[lo[g * G:(g + 1) * G].min(), hi[g * G:(g + 1) * G].max()] for g in range(groups)]
    got = fk.kchunk_ranges_plain(cqt_bank.cqt_kernels_real, cqt_bank.cqt_kernels_imag)
    assert got.tolist() == want
    assert want[0] == [2522, 13862]  # bin 0's atom: 11,340 samples


def test_ranges_of_a_dense_bank_are_full():
    rng = np.random.RandomState(1)
    wc, ws = (torch.from_numpy(rng.randn(84, 3000).astype(np.float32)) for _ in range(2))
    assert fk.kchunk_ranges_plain(wc, ws).tolist() == [[0, 3000]] * -(-84 // G)


def test_a_zero_group_has_an_empty_range_and_gives_sqrt_eps():
    wc, ws = _banded(3 * G, 2048, 2, zero_group=1)
    ranges = fk.kchunk_ranges_plain(wc, ws)
    assert ranges[1].tolist() == [0, 0] and (ranges[[0, 2], 1] > 0).all()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 2048 + 64 * 9).astype(np.float32))
    rows = slice(G, 2 * G)
    mag = fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, 64, eps=1e-8)
    power = fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, 64, square=True)
    assert torch.equal(mag[:, rows], torch.full_like(mag[:, rows], 1e-8).sqrt())
    assert torch.equal(power[:, rows], torch.zeros_like(power[:, rows]))
    assert _rel(mag, fk.framed_magnitude_plain(x, wc, ws, 64, eps=1e-8)) <= TOL


def test_an_entry_set_in_place_widens_the_range(cqt_bank):
    """The ranges come from the bank as it is at the call: one entry set far
    outside the top bin's atom widens its group's range to column 0, and
    the banded result still equals the plain version."""
    wc = cqt_bank.cqt_kernels_real.clone()
    ws = cqt_bank.cqt_kernels_imag
    before = fk.kchunk_ranges_plain(wc, ws)
    wc[-1, 0] = 0.25
    after = fk.kchunk_ranges_plain(wc, ws)
    assert before[-1, 0] > 0 and after[-1].tolist() == [0, int(before[-1, 1])]
    assert torch.equal(after[:-1], before[:-1])
    n = wc.shape[1]
    x = torch.from_numpy(np.random.RandomState(4).randn(1, n + 512 * 4).astype(np.float32))
    got = fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, 512, eps=1e-8)
    assert _rel(got, fk.framed_magnitude_plain(x, wc, ws, 512, eps=1e-8)) <= TOL


@pytest.mark.parametrize("bank,length,hop,kw", [
    ("cqt", 16384 + 512 * 5, 512, dict(eps=1e-8)),
    ("cqt", 16384 + 441 * 5, 441, dict(square=True)),
    ("banded", 4093 + 3 * 300, 3, dict(eps=1e-8)),     # hop 3, rows off 16 bytes
    ("banded", 5000 + 100 * 40, 100, dict(square=True)),  # N no K chunk divides
    ("dense", 4096 + 512 * 8, 512, dict(eps=1e-8)),
    ("zero group", 2048 + 64 * 20, 64, dict(eps=1e-8)),
])
def test_banded_3xtf32_twin_matches_the_plain_version(cqt_bank, bank, length, hop, kw):
    rng = np.random.RandomState(5)
    if bank == "cqt":
        wc, ws = cqt_bank.cqt_kernels_real, cqt_bank.cqt_kernels_imag
    elif bank == "dense":
        wc, ws = (torch.from_numpy((rng.randn(128, 4096) * 0.05).astype(np.float32))
                  for _ in range(2))
    else:
        n = {3: 4093, 100: 5000, 64: 2048}[hop]
        wc, ws = _banded(84 if hop != 64 else 3 * G, n, 6,
                         zero_group=1 if bank == "zero group" else None)
    x = torch.from_numpy(rng.randn(2, length).astype(np.float32))
    got = fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, hop, **kw)
    assert _rel(got, fk.framed_magnitude_plain(x, wc, ws, hop, **kw)) <= TOL


@pytest.mark.parametrize("batch,length,f,n,hop,kw", [
    (2, 16384, 84, 8192, 512, dict()),
    (1, 12000, 64, 4096, 320, dict(square=True, eps=1e-8)),
])
def test_banded_3xtf32_twin_matches_interpreted_pallas(batch, length, f, n, hop, kw):
    """The banded twin against the Pallas K-chunked kernel itself
    (interpreted), at the JAX suite's K6 shapes on CQT-shaped banks."""
    x = np.random.RandomState(7).randn(batch, length).astype(np.float32)
    wc, ws = _banded(f, n, 8)
    plan = framed_matmul._plan_kchunk(batch, n, f, (length - n) // hop + 1, hop, True)
    assert plan is not None and plan["nk"] > 1
    framed_matmul._INTERPRET = True
    try:
        want = framed_matmul._framed_magnitude_kchunk(
            jnp.asarray(x), jnp.asarray(wc.numpy()).T, jnp.asarray(ws.numpy()).T, hop,
            highest=True, **kw, **plan)
    finally:
        framed_matmul._INTERPRET = False
    got = fk.framed_magnitude_banded_3xtf32_plain(torch.from_numpy(x), wc, ws, hop, **kw)
    assert _rel(got, want) <= TOL


def test_a_sample_outside_every_range_is_never_multiplied():
    """The kernel's documented difference, in its twin: a NaN at a sample
    that meets only columns outside every group's range leaves the output
    finite, where the plain version (and K1, and JAX) turn it to NaN."""
    wc, ws = _banded(32, 4096, 9)
    assert int(fk.kchunk_ranges_plain(wc, ws)[:, 0].min()) >= 2 * fk.KCHUNK_BK[torch.float32]
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 4096 + 512 * 4).astype(np.float32))
    x[0, 0] = float("nan")
    assert torch.isfinite(fk.framed_magnitude_banded_3xtf32_plain(x, wc, ws, 512)).all()
    assert torch.isnan(fk.framed_magnitude_plain(x, wc, ws, 512)).any()


@pytest.mark.parametrize("b,f,n,t,splits,dtype,want", [
    # header + packed (planes x 2 x cap x npad x size, to 256) + partials
    (32, 84, 16384, 431, 1, torch.float32, 2048 + 2 * 2 * 96 * 16384 * 4),
    (1, 84, 16384, 431, 32, torch.float32,
     2048 + 2 * 2 * 96 * 16384 * 4 + 2 * 32 * 84 * 431 * 4),
    (2, 1, 4093, 9, 3, torch.bfloat16, 2048 + 2 * 32 * 4096 * 2 + 2 * 3 * 2 * 9 * 4),
    (1, 128, 5000, 3, 1, torch.float32, 2048 + 2 * 2 * 128 * 5024 * 4),
])
def test_kchunk_workspace_bytes(b, f, n, t, splits, dtype, want):
    assert fk.kchunk_workspace_bytes(b, f, n, t, splits, dtype) == want
