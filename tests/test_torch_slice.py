"""The port's serving slice end to end: the flagship classifier against the
JAX model, the port's import boundary and its device rule."""
import ast
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nnaudio_tpu.models import SpectrogramClassifier as JaxClassifier
from nnaudio_tpu_torch.interop import load_jax_state, params_from_jax
from nnaudio_tpu_torch.models import SpectrogramClassifier

ROOT = Path(__file__).resolve().parent.parent


def test_classifier_logits_match_jax():
    """2 x 1 s at the entry configuration, with perturbed mel_basis, head_w
    and head_b carried across by interop."""
    kw = dict(n_classes=10, sr=16000, n_fft=1024, hop_length=256, n_mels=64)
    jm = JaxClassifier(**kw)
    rng = np.random.RandomState(12)
    params = {k: np.asarray(v) for k, v in jm.init_params.items()}
    params["mel_basis"] = params["mel_basis"] * (1 + 0.2 * rng.randn(*params["mel_basis"].shape)).astype(np.float32)
    params["head_w"] = params["head_w"] + 0.1 * rng.randn(*params["head_w"].shape).astype(np.float32)
    params["head_b"] = rng.randn(10).astype(np.float32)
    x = rng.randn(2, 16000).astype(np.float32)
    labels = np.array([3, 7])

    want = np.asarray(jm.forward({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(x)))
    tm = SpectrogramClassifier(device="cpu", **kw)
    assert set(tm.state_dict()) == set(params)
    got = tm.forward(params_from_jax(params, "cpu"), x).detach().numpy()
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4), np.abs(got - want).max()

    load_jax_state(tm, params)
    assert np.allclose(tm(None, x).detach().numpy(), want, rtol=1e-4, atol=1e-4)
    jloss = float(jm.loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jnp.asarray(labels)))
    assert np.isclose(tm.loss_fn(None, x, labels).item(), jloss, rtol=1e-4, atol=1e-4)


def test_the_cqt_slice_is_in_the_package():
    """The modules of the CQT/VQT slice exist (so the no-JAX scan below
    covers them) and export the classes the JAX package exports."""
    import nnaudio_tpu.features as jfeatures
    import nnaudio_tpu_torch.features as tfeatures

    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("filters/cqt.py", "core/resample.py", "features/cqt.py",
                "features/vqt.py", "ops/framed_kernels.py"):
        assert f"nnaudio_tpu_torch/{rel}" in scanned
    assert (ROOT / "nnaudio_tpu_torch/csrc/framed_kchunk.cu").exists()
    for name in ("CQT", "CQT1992", "CQT1992v2", "CQT2010", "CQT2010v2", "VQT"):
        assert name in tfeatures.__all__ and hasattr(jfeatures, name)


def test_the_tensor_core_kernels_have_their_own_source():
    """K1, K2, K4 and K5 live in csrc/framed_tc.cu, on its tensor-core main
    loop, and the wrappers bind all four from it; framed_analysis.cu, the
    CUDA-core kernels they replaced, is gone."""
    from nnaudio_tpu_torch.ops import framed_kernels as fk

    csrc = ROOT / "nnaudio_tpu_torch/csrc"
    tc = (csrc / "framed_tc.cu").read_text()
    assert not (csrc / "framed_analysis.cu").exists()
    for entry in ("nnaudio_framed_magnitude", "nnaudio_framed_pair",
                  "nnaudio_framed_filterbank", "nnaudio_gl_step"):
        assert f'extern "C" int {entry}(' in tc
        assert fk._SIGNATURES[entry][0] == "framed_tc"
    for epilogue in ("PAIR", "MAGNITUDE", "FILTERBANK", "GL_STEP"):
        assert f"epilogue == {epilogue}" in tc
    # the `wgmma` building blocks are shared with K3 in one header
    assert '#include "tc_common.cuh"' in tc
    tc += (csrc / "tc_common.cuh").read_text()
    assert "wgmma.mma_async" in tc and "fmaf" not in tc


def test_the_synthesis_runs_on_the_tensor_cores():
    """K3 keeps its entry point and source, csrc/synthesis_ola.cu, and runs
    the shared `wgmma` main loop's parts: no FMA loop is left."""
    from nnaudio_tpu_torch.ops import framed_kernels as fk

    csrc = ROOT / "nnaudio_tpu_torch/csrc"
    syn = (csrc / "synthesis_ola.cu").read_text()
    assert 'extern "C" int nnaudio_synthesis_ola(' in syn
    assert fk._SIGNATURES["nnaudio_synthesis_ola"][0] == "synthesis_ola"
    assert '#include "tc_common.cuh"' in syn and "Mma<" in syn
    assert "fmaf" not in syn


def _port_sources():
    yield from sorted((ROOT / "nnaudio_tpu_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


@pytest.mark.parametrize("path", list(_port_sources()), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """Neither the port nor chip_smoke.py imports jax, jaxlib or nnaudio_tpu."""
    banned = ("jax", "jaxlib", "nnaudio_tpu")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative imports stay inside the package
                continue
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__"):
            names = [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in banned, f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_refuse_the_cpu_without_a_device_argument():
    """Without CUDA, an entry point called without ``device=`` raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    from nnaudio_tpu_torch.features import (CQT, CQT1992, CQT1992v2, CQT2010,
                                            CQT2010v2, Griffin_Lim,
                                            InverseMelSpectrogram, InverseMFCC,
                                            MelSpectrogram, STFT, VQT, iSTFT)

    for make in (lambda: STFT(verbose=False), lambda: iSTFT(verbose=False),
                 lambda: MelSpectrogram(verbose=False),
                 lambda: Griffin_Lim(n_fft=256),
                 lambda: InverseMelSpectrogram(verbose=False),
                 lambda: InverseMFCC(verbose=False),
                 lambda: CQT1992v2(verbose=False), lambda: CQT(verbose=False),
                 lambda: CQT1992(), lambda: CQT2010(verbose=False),
                 lambda: CQT2010v2(verbose=False), lambda: VQT(verbose=False),
                 lambda: SpectrogramClassifier(),
                 lambda: params_from_jax({"a": np.zeros(2)}, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
