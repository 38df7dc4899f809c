"""The port's pyramid switches against the serial loop and the JAX package,
on the CPU: ``ops/pyramid`` (the fused pyramid), the parallel decimation
chain with its composed cascades, the derived-state rules of the cascades,
and the three ``set_use_*`` switches of ``config``.

Tolerances are the JAX tests': the fused pyramid against the loop within
``2e-5 * max|ref|`` (tests/test_pyramid_fused.py:84), the parallel chain
against the serial one within ``2e-5 * max|ref|`` plus ``rtol=1e-4``
(tests/test_cqt.py:156).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nnaudio_tpu as jn
import nnaudio_tpu_torch as tn
from nnaudio_tpu import features as jf
from nnaudio_tpu.core import resample as jres
from nnaudio_tpu.ops import pyramid as jpyr
from nnaudio_tpu_torch import config
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch.core import resample as tres
from nnaudio_tpu_torch.filters.cqt import create_lowpass_filter
from nnaudio_tpu_torch.interop import load_jax_state
from nnaudio_tpu_torch.ops import pyramid as tpyr

FUSED_TOL = 2e-5


@pytest.fixture
def switches_off_after():
    yield
    for setter in (tn.set_use_fused_pyramid, tn.set_use_parallel_chain,
                   tn.set_use_mxu_fft, jn.set_use_fused_pyramid,
                   jn.set_use_parallel_chain, jn.set_use_mxu_fft):
        setter(None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _chain_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FUSED_TOL * np.abs(want).max(),
                               rtol=1e-4)


def _with(setter, fn):
    setter(True)
    try:
        return fn()
    finally:
        setter(None)


# ----------------------------------------------------------------- config --
@pytest.mark.parametrize("name", ["fused_pyramid", "mxu_fft", "parallel_chain"])
def test_switches_are_auto_off_and_forceable(name, switches_off_after):
    setter = getattr(tn, f"set_use_{name}")
    field = f"use_{name}"
    assert getattr(config.get_config(), field) is None
    enabled = {"fused_pyramid": tpyr.pyramid_enabled,
               "parallel_chain": config.parallel_chain_enabled,
               "mxu_fft": __import__("nnaudio_tpu_torch.ops.mxu_fft",
                                     fromlist=["x"]).mxu_fft_enabled}[name]
    assert not enabled()
    setter(1)
    assert getattr(config.get_config(), field) is True and enabled()
    setter(False)
    assert getattr(config.get_config(), field) is False and not enabled()
    setter(None)
    assert getattr(config.get_config(), field) is None and not enabled()


# ------------------------------------------------------------ ops/pyramid --
@pytest.mark.parametrize("width,hop", [(256, 512), (256, 256), (256, 8),
                                       (240, 36), (250, 3)])
def test_materialize_frames_matches_jax(width, hop):
    x = np.random.RandomState(0).randn(3, 4096).astype(np.float32)
    got = tpyr.materialize_frames(torch.from_numpy(x), width, hop)
    assert np.array_equal(_np(got), np.asarray(jpyr.materialize_frames(jnp.asarray(x), width, hop)))


def test_materialize_frames_forced_count_pads():
    x = torch.arange(20, dtype=torch.float32)[None]
    got = _np(tpyr.materialize_frames(x, 8, 4, t=5))
    assert got.shape == (1, 5, 8)
    assert np.array_equal(got[0, 4], [16, 17, 18, 19, 0, 0, 0, 0])


def test_pyramid_basis_pair_mismatched_frames_returns_none():
    levels = [torch.zeros(1, 1024), torch.zeros(1, 400)]
    br = [torch.zeros(4, 64)] * 2
    assert tpyr.pyramid_basis_pair(levels, br, br, [64, 32]) is None


def test_pyramid_basis_pair_matches_jax():
    rng = np.random.RandomState(1)
    levels = [rng.randn(2, n).astype(np.float32) for n in (1300, 2600)]
    banks_r = [rng.randn(6, w).astype(np.float32) for w in (64, 128)]
    banks_i = [rng.randn(6, w).astype(np.float32) for w in (64, 128)]
    got = tpyr.pyramid_basis_pair([torch.from_numpy(v) for v in levels],
                                  [torch.from_numpy(v) for v in banks_r],
                                  [torch.from_numpy(v) for v in banks_i], [16, 32])
    want = jpyr.pyramid_basis_pair([jnp.asarray(v) for v in levels],
                                   [jnp.asarray(v) for v in banks_r],
                                   [jnp.asarray(v) for v in banks_i], [16, 32])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(_np(g) - w).max() <= 1e-5 * np.abs(w).max()


BUILDS = {
    "VQT gamma 2": ("VQT", dict(gamma=2)),
    "CQT2010v2": ("CQT2010v2", {}),
    "CQT2010v2 80 bins, constant pad": ("CQT2010v2", dict(n_bins=80, pad_mode="constant")),
    "CQT2010": ("CQT2010", {}),
}


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("fmt", ["Magnitude", "Complex"])
def test_fused_matches_loop_and_jax(build, fmt, switches_off_after):
    """The fused pyramid against the per-octave loop (tests/
    test_pyramid_fused.py:76), and against the JAX package's fused path."""
    cls, kw = BUILDS[build]
    kw = {**dict(sr=22050, hop_length=512, n_bins=84, bins_per_octave=12,
                 verbose=False), **kw}
    x = np.random.RandomState(1).randn(2, 22050 + 333).astype(np.float32)
    tl = getattr(tf, cls)(device="cpu", **kw)
    loop = tl(x, output_format=fmt)
    fused = _with(tn.set_use_fused_pyramid, lambda: tl(x, output_format=fmt))
    scale = np.abs(_np(loop)).max()
    np.testing.assert_allclose(_np(fused), _np(loop), atol=FUSED_TOL * scale)
    jl = getattr(jf, cls)(**kw)
    want = _with(jn.set_use_fused_pyramid, lambda: np.asarray(jl(x, output_format=fmt)))
    np.testing.assert_allclose(_np(fused), want, atol=1e-4 * scale)


def test_fused_trainable_gradients_match_loop(switches_off_after):
    """Trainable CQT2010v2: the shared bank appears once per level in the
    fused stack; its gradient equals the loop's sum over octaves."""
    x = np.random.RandomState(2).randn(1, 22050).astype(np.float32)
    tl = tf.CQT2010v2(sr=22050, hop_length=512, n_bins=84, bins_per_octave=12,
                      trainable=True, verbose=False, device="cpu")

    def grads():
        tl.zero_grad()
        (tl(x) ** 2).sum().backward()
        return [tl.cqt_kernels_real.grad.clone(), tl.cqt_kernels_imag.grad.clone()]
    loop = grads()
    fused = _with(tn.set_use_fused_pyramid, grads)
    for a, b in zip(fused, loop):
        np.testing.assert_allclose(_np(a), _np(b), atol=FUSED_TOL * np.abs(_np(b)).max())


# ---------------------------------------------------------- parallel chain --
@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_compose_cascade_equals_jax(k):
    fir = create_lowpass_filter(band_center=0.5, kernel_length=256,
                                transition_bandwidth=0.001)
    assert np.array_equal(tres.compose_cascade(fir, k), jres.compose_cascade(fir, k))


@pytest.mark.parametrize("k", [2, 4])
def test_compose_cascade_torch_matches_fp64(k):
    fir = create_lowpass_filter(band_center=0.5, kernel_length=256,
                                transition_bandwidth=0.001)
    got = _np(tres.compose_cascade_torch(torch.from_numpy(fir), k))
    want = tres.compose_cascade(fir, k)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# odd lengths, no multiple of 2^(n_octaves-1) = 64: the serial chain's
# floor(L/2) truncation bites at every stage
@pytest.mark.parametrize("length", [22050 * 2, 22050 * 2 + 977, 22050 + 63])
@pytest.mark.parametrize("cls", ["CQT2010v2", "VQT", "CQT2010"])
def test_parallel_chain_matches_serial(length, cls, switches_off_after):
    kw = dict(gamma=2) if cls == "VQT" else {}
    x = np.random.RandomState(30).randn(2, length).astype(np.float32)
    tl = getattr(tf, cls)(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
                          hop_length=512, verbose=False, device="cpu", **kw)
    want = tl(x)
    got = _with(tn.set_use_parallel_chain, lambda: tl(x))
    _chain_close(got, want)


def test_parallel_chain_levels_match_serial_at_the_edges(switches_off_after):
    """Level by level, the edges (the first and last _EDGE_FIX samples,
    where the corrections run) included."""
    tl = tf.CQT2010v2(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
                      hop_length=512, verbose=False, device="cpu")
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 30001).astype(np.float32))
    serial, hops = tl._pyramid_chain(tl.params, x)
    parallel = tl._parallel_levels(tl.params, x)
    assert [p.shape for p in parallel] == [s.shape for s in serial]
    for s, p in zip(serial, parallel):
        e = tl._EDGE_FIX
        for part in (slice(0, e), slice(-e, None), slice(None)):
            np.testing.assert_allclose(_np(p[:, part]), _np(s[:, part]),
                                       atol=FUSED_TOL * float(s.abs().max()))


def test_parallel_chain_matches_serial_early_downsample(switches_off_after):
    x = np.random.RandomState(31).randn(1, 44100).astype(np.float32)
    tl = tf.CQT2010v2(sr=44100, fmin=220, n_bins=48, bins_per_octave=12,
                      hop_length=512, earlydownsample=True, verbose=False,
                      device="cpu")
    assert tl.earlydownsample
    want = tl(x)
    _chain_close(_with(tn.set_use_parallel_chain, lambda: tl(x)), want)


def test_parallel_chain_matches_jax(switches_off_after):
    kw = dict(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
              hop_length=512, verbose=False)
    x = np.random.RandomState(32).randn(2, 22050 + 977).astype(np.float32)
    tl, jl = tf.VQT(gamma=2, device="cpu", **kw), jf.VQT(gamma=2, **kw)
    got = _with(tn.set_use_parallel_chain, lambda: tl(x))
    want = _with(jn.set_use_parallel_chain, lambda: np.asarray(jl(x)))
    _chain_close(got, want)


def test_cascades_are_derived_not_state(switches_off_after):
    """The cascades are out of the state, rebuilt in fp64 from the stored
    filter after update_params, load_state_dict and an in-place change; a
    JAX snapshot with legacy cascade keys loads and the keys are ignored."""
    tl = tf.CQT2010v2(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
                      hop_length=512, verbose=False, device="cpu")
    jl = jf.CQT2010v2(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
                      hop_length=512, verbose=False)
    assert set(tl.state_dict()) == set(jl.state_dict())
    assert not any(k.startswith("lowpass_cascade") for k in tl.state_dict())
    params = tl.params
    fir = tl.lowpass_filter.double().numpy()
    assert np.allclose(_np(tl._cascade(params, 3)), tres.compose_cascade(fir, 3), atol=1e-7)

    new_fir = create_lowpass_filter(band_center=0.45, kernel_length=256,
                                    transition_bandwidth=0.002)
    tl.update_params({"lowpass_filter": new_fir})
    want = tres.compose_cascade(new_fir.astype(np.float32), 3)
    assert np.allclose(_np(tl._cascade(tl.params, 3)), want, atol=1e-7)

    with torch.no_grad():
        tl.lowpass_filter.mul_(2.0)  # in place: the cascade follows
    assert np.allclose(_np(tl._cascade(tl.params, 2)),
                       tres.compose_cascade(tl.lowpass_filter.double().numpy(), 2),
                       atol=1e-6)

    legacy = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    legacy["lowpass_cascade_2"] = np.zeros(766, np.float32)
    load_jax_state(tl, legacy)
    cascade = _np(tl._cascade(tl.params, 2))
    assert np.abs(cascade).max() > 0
    assert np.allclose(cascade, jres.compose_cascade(legacy["lowpass_filter"], 2), atol=1e-7)


def test_parallel_chain_follows_a_filter_loaded_by_assignment(switches_off_after):
    """load_state_dict(assign=True) puts in a new tensor whose version may
    equal the old one's: the cascades are rebuilt from it, and the parallel
    chain agrees with the serial chain on the new filter (tolerance of
    tests/test_cqt.py:156)."""
    tl = tf.CQT2010v2(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
                      hop_length=512, verbose=False, device="cpu")
    x = np.random.RandomState(34).randn(1, 22050 + 977).astype(np.float32)
    _with(tn.set_use_parallel_chain, lambda: tl(x))  # cascades of the old filter
    new_fir = create_lowpass_filter(band_center=0.45, kernel_length=256,
                                    transition_bandwidth=0.002).astype(np.float32)
    state = dict(tl.state_dict())
    state["lowpass_filter"] = torch.from_numpy(new_fir)
    tl.load_state_dict(state, assign=True)
    want = tl(x)
    got = _with(tn.set_use_parallel_chain, lambda: tl(x))
    assert np.allclose(_np(tl._cascade(tl.params, 3)),
                       tres.compose_cascade(new_fir, 3), atol=1e-7)
    _chain_close(got, want)


def test_parallel_chain_tracks_a_lowpass_override(switches_off_after):
    """A filter passed to apply reaches the parallel chain (composed in
    torch, so gradients flow to it) and agrees with the serial chain and
    with JAX's gradient through its own in-graph composition."""
    kw = dict(sr=22050, fmin=32.7, n_bins=84, bins_per_octave=12,
              hop_length=512, verbose=False)
    x = np.random.RandomState(33).randn(1, 22050).astype(np.float32)
    tl, jl = tf.CQT2010v2(device="cpu", **kw), jf.CQT2010v2(**kw)
    new_fir = create_lowpass_filter(band_center=0.45, kernel_length=256,
                                    transition_bandwidth=0.002).astype(np.float32)
    override = {"lowpass_filter": torch.from_numpy(new_fir)}
    want = tl.apply(override, x)
    assert float((want - tl(x)).abs().max()) > 0
    _chain_close(_with(tn.set_use_parallel_chain, lambda: tl.apply(override, x)), want)

    leaf = torch.from_numpy(new_fir).requires_grad_()
    got = _with(tn.set_use_parallel_chain,
                lambda: torch.autograd.grad(tl.apply({"lowpass_filter": leaf}, x).sum(),
                                            leaf)[0])
    jgrad = _with(jn.set_use_parallel_chain, lambda: np.asarray(jax.grad(
        lambda f: jnp.sum(jl.apply({"lowpass_filter": f}, x)))(jnp.asarray(new_fir))))
    assert np.abs(_np(got) - jgrad).max() <= 1e-3 * np.abs(jgrad).max()
