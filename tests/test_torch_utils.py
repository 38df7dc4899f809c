"""The port's ``utils`` against the JAX package's on the CPU: bucket
boundaries, padding and frame masks equal to ``nnaudio_tpu.utils``'s; an
``.npz`` written by the JAX package restored into the port (and back);
``restore_transform(strict=)`` with the JAX package's meaning; the
``torch.save`` format; the profiler trace."""
import glob
import os
import warnings

import numpy as np
import pytest
import torch

from nnaudio_tpu import features as jf
from nnaudio_tpu import utils as ju
from nnaudio_tpu_torch import features as tf
from nnaudio_tpu_torch import utils as tu


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kw", [dict(), dict(max_seconds=10, sr=8000),
                                dict(max_seconds=4, sr=16000, granularity=2.0)])
def test_default_buckets_equal(kw):
    assert tu.default_buckets(**kw) == ju.default_buckets(**kw)


@pytest.mark.parametrize("length", [1, 8000, 8500, 23999, 10**9])
def test_bucket_length_equal(length):
    buckets = ju.default_buckets(max_seconds=10, sr=8000)
    assert tu.bucket_length(length, buckets) == ju.bucket_length(length, buckets)


def test_pad_to_bucket_equal():
    rng = np.random.RandomState(0)
    sigs = [rng.randn(5000).astype(np.float32), rng.randn(7300).astype(np.float32)]
    buckets = ju.default_buckets(max_seconds=10, sr=8000)
    got, valid = tu.pad_to_bucket(sigs, buckets, device="cpu")
    want, jvalid = ju.pad_to_bucket(sigs, buckets)
    assert np.array_equal(_np(got), np.asarray(want))
    assert np.array_equal(_np(valid), np.asarray(jvalid))
    # a signal past the largest bucket is cut, with a warning, in both
    long = [rng.randn(90000).astype(np.float32)]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, valid = tu.pad_to_bucket(long, buckets, device="cpu")
        want, jvalid = ju.pad_to_bucket(long, buckets)
    assert sum("truncated" in str(r.message) for r in rec) == 2
    assert np.array_equal(_np(got), np.asarray(want)) and int(valid[0]) == int(jvalid[0])


@pytest.mark.parametrize("center", [True, False])
def test_frame_masks_equal(center):
    valid = np.array([0, 300, 5000, 7300, 8192])
    got = tu.frame_mask(70, torch.as_tensor(valid), 512, 128, center=center)
    want = ju.frame_mask(70, valid, 512, 128, center=center)
    assert got.dtype == torch.float32
    assert np.array_equal(_np(got), np.asarray(want))
    for v in valid:
        assert int(tu.valid_frame_count(int(v), 512, 128, center)) == int(
            ju.valid_frame_count(int(v), 512, 128, center))


def test_masked_frames_match_unpadded_frames():
    """tests/test_utils.py: the masked frames of a padded batch are the
    frames of each utterance alone."""
    rng = np.random.RandomState(0)
    sigs = [rng.randn(5000).astype(np.float32), rng.randn(7300).astype(np.float32)]
    batch, valid = tu.pad_to_bucket(sigs, tu.default_buckets(max_seconds=10, sr=8000),
                                    device="cpu")
    layer = tf.STFT(n_fft=512, hop_length=128, center=False, output_format="Magnitude",
                    verbose=False, device="cpu")
    spec = _np(layer(batch))
    mask = _np(tu.frame_mask(spec.shape[-1], valid, 512, 128, center=False))
    for i, s in enumerate(sigs):
        k = int(tu.valid_frame_count(valid[i], 512, 128, center=False))
        assert mask[i, :k].all() and not mask[i, k:].any()
        np.testing.assert_allclose(spec[i][:, :k], _np(layer(s[None]))[0][:, :k],
                                   rtol=1e-4, atol=1e-5)


def test_npz_written_by_the_jax_package_restores_into_the_port(tmp_path):
    """A trainable Mel's state saved by the JAX package loads into the port
    (restore_transform) and gives the JAX output; saved back by the port it
    loads into the JAX package unchanged."""
    jl = jf.MelSpectrogram(sr=16000, n_fft=512, hop_length=128, n_mels=32,
                           trainable_mel=True, verbose=False)
    rng = np.random.RandomState(1)
    jl.update_params({"mel_basis": np.asarray(jl.params["mel_basis"])
                      * (1 + 0.1 * rng.rand(32, 257)).astype(np.float32)})
    path = str(tmp_path / "mel.npz")
    ju.save_params(path, jl.params)
    tl = tf.MelSpectrogram(sr=16000, n_fft=512, hop_length=128, n_mels=32,
                           trainable_mel=True, verbose=False, device="cpu")
    tu.restore_transform(tl, path)
    for k, v in jl.params.items():
        assert np.array_equal(_np(tl.params[k]), np.asarray(v)), k
    x = rng.randn(2, 4096).astype(np.float32)
    want = np.asarray(jl(x))
    assert np.abs(_np(tl(x)) - want).max() <= 1e-4 * np.abs(want).max()
    back = str(tmp_path / "back.npz")
    tu.save_params(back, tl.params)
    loaded = ju.load_params(back)
    assert set(loaded) == set(jl.params)
    for k in loaded:
        assert np.array_equal(loaded[k], np.asarray(jl.params[k])), k


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_save_load_round_trip_is_exact(tmp_path, suffix):
    layer = tf.STFT(n_fft=512, hop_length=128, trainable=True, output_format="Magnitude",
                    verbose=False, device="cpu")
    with torch.no_grad():
        layer.wsin.mul_(1.5)
    path = str(tmp_path / f"stft{suffix}")
    tu.save_params(path, layer.params)
    loaded = tu.load_params(path)
    assert set(loaded) == set(layer.params)
    for k, v in loaded.items():
        assert torch.equal(torch.as_tensor(v), layer.params[k].detach()), k


def test_restore_transform_strict(tmp_path):
    """strict (the default) refuses a checkpoint with missing or unexpected
    keys, strict=False loads the intersection, as in the JAX package."""
    layer = tf.MelSpectrogram(n_fft=512, hop_length=128, n_mels=32, trainable_mel=True,
                              verbose=False, device="cpu")
    jlayer = jf.MelSpectrogram(n_fft=512, hop_length=128, n_mels=32, trainable_mel=True,
                               verbose=False)
    partial = {"mel_basis": np.asarray(jlayer.params["mel_basis"]) * 2}
    path = str(tmp_path / "partial.npz")
    ju.save_params(path, partial)
    with pytest.raises((KeyError, RuntimeError)):
        ju.restore_transform(jlayer, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        tu.restore_transform(layer, path)
    before = layer.wsin.detach().clone()
    tu.restore_transform(layer, path, strict=False)
    ju.restore_transform(jlayer, path, strict=False)
    assert np.array_equal(_np(layer.mel_basis), np.asarray(jlayer.params["mel_basis"]))
    assert torch.equal(layer.wsin, before)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    layer = tf.STFT(n_fft=256, hop_length=64, verbose=False, device="cpu")
    x = np.random.RandomState(0).randn(1, 2048).astype(np.float32)
    logdir = str(tmp_path / "trace")
    with tu.trace(logdir) as d:
        assert d == logdir
        layer(x)
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0


def test_utils_has_every_public_name_of_the_jax_package():
    assert set(tu.__all__) == set(ju.__all__)
    for name in ju.__all__:
        assert hasattr(tu, name), name
