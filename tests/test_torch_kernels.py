"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one, run ``python -m pytest tests/test_torch_kernels.py -q``;
``python3 chip_smoke.py`` runs the same checks at the slice's full widths.
"""
import pytest
import torch

from nnaudio_tpu_torch import config
from nnaudio_tpu_torch.ops import framed_kernels as fk

pytestmark = pytest.mark.cuda

TOL = {"highest": 1e-4, "default": 5e-2}  # tests/test_ops.py:213-216


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


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
    assert all(fk.LAUNCHES[k] == before[k] + 1 for k in before)
    assert _rel(k1, fk.framed_magnitude_plain(x, wc, ws, hop, eps=1e-8)) <= TOL[mode]
    assert _rel(k2, fk.framed_filterbank_plain(x, wc, ws, fb, hop, eps=1e-8)) <= TOL[mode]
    assert _rel(k3, fk.synthesis_ola_plain(sre, sim, wc, ws, hop)) <= TOL[mode]


def test_kernel_backward_raises(cuda):
    x = torch.randn(1, 4096, device=cuda)
    w = torch.randn(65, 128, device=cuda, requires_grad=True)
    out = fk.framed_magnitude(x, w, w, 32)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()
