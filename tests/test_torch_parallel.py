"""The port's ``parallel`` package across processes on the CPU, against the
JAX package's single-device results.

A module fixture spawns this file as a worker in a gloo process group of 4
ranks, then of 2 (``python tests/test_torch_parallel.py <world> <rank>
<init file> <output dir> <checkpoint dir>``), each with a ``file://`` init
method in ``tmp_path`` and a time limit. Every worker runs every case of
``tests/test_sharding.py`` that a process group can hold and saves its part;
the tests gather the parts and hold them: data parallel STFT and Mel equal to
the port's single-device output bit for bit and to JAX at 1e-4 of max |ref|;
the data-parallel gradients at rtol 1e-4, atol 1e-5; the bank-sharded and
contraction-sharded CQTs, the time-sharded STFT and the sharded inverse at
the JAX test's own tolerances against the port's single-device output and at
1e-4 of max |ref| against JAX; the checkpoint saved on 4 ranks restored onto
2 exactly.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (4, 2)      # the 4-rank world saves the checkpoint the 2-rank world restores
TIMEOUT = 240        # seconds per world: a hung rank fails the tests
REL = 1e-4           # port against JAX (ROADMAP: the framed ops)
CQT_KW = dict(sr=16000, fmin=55, n_bins=48, bins_per_octave=12, hop_length=512)
C1992_KW = dict(sr=16000, fmin=220, n_bins=40, bins_per_octave=12, hop_length=256)
INV_KW = dict(sr=22050, fmin=55, n_bins=48, hop_length=128)
CONTRACTION = [("Magnitude", "librosa"), ("Complex", "convolutional"),
               ("Phase", "librosa"), ("Magnitude", "wrap")]


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bank_layers(tf, device="cpu"):
    """(name, layer, input) of the bank-sharded cases (tests/test_sharding.py)."""
    return [
        ("cqt1992v2", tf.CQT1992v2(verbose=False, device=device, **CQT_KW), _x(2, 4, 16384)),
        ("vqt", tf.VQT(gamma=2, verbose=False, device=device, **CQT_KW), _x(14, 4, 16384)),
        ("cqt2010v2", tf.CQT2010v2(verbose=False, device=device, **CQT_KW), _x(15, 4, 16384)),
        ("cqt1992_frozen", tf.CQT1992(device=device, **{**CQT_KW, "hop_length": 256}),
         _x(11, 4, 8192)),
    ]


def _inverse_layers(tf, device="cpu"):
    return [("1992v2", tf.CQT1992v2(output_format="Complex", verbose=False, device=device,
                                     **INV_KW)),
            ("2010v2", tf.CQT2010v2(bins_per_octave=12, earlydownsample=False,
                                    output_format="Complex", verbose=False, device=device,
                                    **INV_KW))]


# ------------------------------------------------------------------ worker --
def _worker(world: int, rank: int, init: str, out_dir: str, ckpt: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from nnaudio_tpu_torch import features as tf
    from nnaudio_tpu_torch import parallel, streaming
    from nnaudio_tpu_torch.core.overlap import extend_fbins
    from nnaudio_tpu_torch.utils import load_sharded, save_sharded

    torch.set_num_threads(1)
    # the explicit-kwargs path, then a second call: a no-op
    parallel.distributed_initialize(backend="gloo", init_method=f"file://{init}",
                                    world_size=world, rank=rank)
    parallel.distributed_initialize()
    assert dist.get_world_size() == world and dist.get_rank() == rank
    res = {}

    def keep(key, t):
        res[key] = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    # -- data parallel over a (world, 1) mesh
    dp = parallel.make_mesh()
    keep("dp_coord", [dp.get_local_rank("data"), dp.get_local_rank("model")])
    for data, model in ((None, 3), (world, 2), (1, 1)):
        try:
            parallel.make_mesh(data=data, model=model)
            keep(f"mesh_error_{data}_{model}", False)
        except ValueError:
            keep(f"mesh_error_{data}_{model}", True)
    stft = tf.STFT(n_fft=512, hop_length=128, output_format="Magnitude", verbose=False,
                   device="cpu")
    keep("dp_stft", parallel.data_parallel(stft, dp, output_format="Magnitude")(
        parallel.shard_batch(_x(0, 16, 4096), dp)))
    mel = tf.MelSpectrogram(n_fft=1024, hop_length=256, n_mels=64, verbose=False, device="cpu")
    keep("dp_mel", parallel.data_parallel(mel, dp)(parallel.shard_batch(_x(1, 8, 8192), dp)))
    trainable = tf.STFT(n_fft=256, hop_length=64, trainable=True, output_format="Magnitude",
                        verbose=False, device="cpu")
    out = parallel.data_parallel(trainable, dp, output_format="Magnitude")(
        parallel.shard_batch(_x(5, 8, 2048), dp))
    g_wsin, g_wcos = torch.autograd.grad(out.sum(), [trainable.wsin, trainable.wcos])
    keep("dp_grad_wsin", g_wsin)
    keep("dp_grad_wcos", g_wcos)
    local = parallel.shard_batch(_x(40, 8, 128 * 40), dp)
    s = streaming.StreamingSTFT(n_fft=512, hop_length=128, device="cpu")
    keep("dp_stream", torch.cat(list(s.stream(local, 128 * 8)), dim=2))
    batches = [local[:, :256] * k for k in range(3)]
    keep("host_batches_equal", all(torch.equal(a, b) for a, b in zip(
        parallel.iter_host_batches(iter(batches), dp), batches)))
    try:
        parallel.global_batch_from_host_local(local, dp, axis="time")
        keep("host_batch_bad_axis_raises", False)
    except ValueError:
        keep("host_batch_bad_axis_raises", True)

    # -- the bank over `model`: a (world/2, 2) mesh
    tp = parallel.make_mesh(model=2)
    keep("tp_coord", [tp.get_local_rank("data"), tp.get_local_rank("model")])
    for name, layer, x in _bank_layers(tf):
        run = parallel.bank_sharded_apply(layer, tp, output_format="Magnitude",
                                          normalization_type="librosa")
        keep(f"bank_{name}", run(parallel.shard_batch(x, tp)))
        keep(f"bank_{name}_rows", run.rows)
    cqt = tf.CQT1992v2(verbose=False, device="cpu", **CQT_KW)
    sharded = parallel.shard_kernel_bank(cqt.params, tp)
    keep("layout_ok", sharded["cqt_kernels_real"].placements == (Replicate(), Shard(0))
         and sharded["lenghts"].placements == (Replicate(), Replicate())
         and torch.equal(sharded["cqt_kernels_real"].to_local(),
                         cqt.cqt_kernels_real.chunk(2)[tp.get_local_rank("model")]))
    for name, layer in _inverse_layers(tf):
        X = layer(_x(9, 4, 8192))
        keep(f"inverse_{name}", parallel.bank.bank_sharded_inverse(layer, tp)(
            parallel.shard_batch(X, tp)))

    # -- the contraction over `model`: a (1, world) mesh
    cm = parallel.make_mesh(data=1, model=world)
    c1992 = tf.CQT1992(trainable_CQT=True, device="cpu", **C1992_KW)
    for i, (fmt, norm) in enumerate(CONTRACTION):
        keep(f"contraction_{fmt}_{norm}", parallel.contraction_sharded_cqt1992(
            c1992, cm, output_format=fmt, normalization_type=norm)(_x(12 + (i > 0), 2, 8192)))

    # -- time over `data`: this rank's piece of the signal
    st = tf.STFT(n_fft=512, hop_length=128, center=False, output_format="Complex",
                 verbose=False, device="cpu")
    r = dp.get_local_rank("data")
    x = _x(3, 2, world * 2048)[:, r * 2048:(r + 1) * 2048]
    real, imag = parallel.time_sharded_stft(x, st.wcos, st.wsin, 128, dp)
    keep("time_real", real)
    keep("time_imag", imag)
    x = _x(4, 1, world * 1024)[:, r * 1024:(r + 1) * 1024]
    real, imag = parallel.time_sharded_stft(x, st.wcos, st.wsin, 128, dp)
    spec = extend_fbins(torch.stack((real, -imag), dim=-1))
    ist = tf.iSTFT(n_fft=512, hop_length=128, verbose=False, device="cpu")
    keep("time_round_trip", parallel.time_sharded_istft(
        spec[..., 0], spec[..., 1], ist.kernel_cos, ist.kernel_sin, ist.window_mask, 128, dp))

    # -- a checkpoint of the bank sharded over 4 ranks, restored onto 2
    if world == 4:
        save_sharded(ckpt, parallel.shard_kernel_bank(cqt.params, cm))
    else:
        onto = (Replicate(), Shard(0))
        restored = load_sharded(ckpt, cqt.params, {"cqt_kernels_real": (cm, onto),
                                                   "cqt_kernels_imag": (cm, onto)})
        m = cm.get_local_rank("model")
        keep("restored_ok", all(torch.equal(restored[k].to_local(), v.chunk(2)[m])
                                for k, v in cqt.params.items() if k.startswith("cqt_"))
             and torch.equal(restored["lenghts"], cqt.lenghts)
             and restored["cqt_kernels_real"].placements == onto)
        run = parallel.bank_sharded_apply(cqt, cm, output_format="Magnitude")
        keep("restored_apply", run(_x(7, 4, 16384), params=restored))
        keep("restored_apply_rows", run.rows)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ parent --
def _spawn(world, tmp: Path, ckpt: Path) -> list[dict]:
    out = tmp / f"world{world}"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(world), str(r), str(tmp / f"init{world}"), str(out),
         str(ckpt)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _gather_data(parts, coord_key, key, model=None):
    """Stack the ranks' rows along the batch in data order (one copy per data
    index: the model ranks of one index hold the same rows)."""
    by_data = {}
    for p in parts:
        d, m = p[coord_key]
        if model is None or m == model:
            by_data[int(d)] = p[key]
    return np.concatenate([by_data[d] for d in sorted(by_data)], axis=0)


def _gather_bank(parts, key):
    """The full (B, F, ...) output from each rank's batch rows and bins."""
    rows = {}
    for p in parts:
        d, _ = p["tp_coord"]
        rows.setdefault(int(d), []).append((p[f"{key}_rows"], p[key]))
    blocks = []
    for d in sorted(rows):
        n = sum(len(r) for r, _ in rows[d])
        first = rows[d][0][1]
        full = np.zeros((first.shape[0], n) + first.shape[2:], first.dtype)
        for r, v in rows[d]:
            full[:, r] = v
        blocks.append(full)
    return np.concatenate(blocks, axis=0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
    sys.exit(0)

import pytest  # noqa: E402  (the parent's tests; the worker above needs neither)
import jax.numpy as jnp  # noqa: E402

from nnaudio_tpu import features as jf  # noqa: E402
from nnaudio_tpu import parallel as jparallel  # noqa: E402
from nnaudio_tpu import streaming as jstreaming  # noqa: E402
from nnaudio_tpu_torch import features as tf  # noqa: E402
from nnaudio_tpu_torch import parallel  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results: 4 ranks first (they save the
    checkpoint), then 2 (they restore it)."""
    tmp = tmp_path_factory.mktemp("parallel")
    return {w: _spawn(w, tmp, tmp / "ckpt") for w in WORLDS}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _one_thread(fn):
    """``fn()`` on one CPU thread, as the workers run: torch's CPU matmuls
    may sum in another order on another thread count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(prev)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_stft_and_mel_exact(worlds, world):
    parts = worlds[world]
    for key, layer, jlayer, x in (
            ("dp_stft", tf.STFT(n_fft=512, hop_length=128, output_format="Magnitude",
                                verbose=False, device="cpu"),
             jf.STFT(n_fft=512, hop_length=128, output_format="Magnitude", verbose=False),
             _x(0, 16, 4096)),
            ("dp_mel", tf.MelSpectrogram(n_fft=1024, hop_length=256, n_mels=64,
                                         verbose=False, device="cpu"),
             jf.MelSpectrogram(n_fft=1024, hop_length=256, n_mels=64, verbose=False),
             _x(1, 8, 8192))):
        got = _gather_data(parts, "dp_coord", key)
        assert np.array_equal(got, _np(_one_thread(lambda: layer(x)))), key
        assert _rel(got, jlayer(x)) <= REL, key


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_grads(worlds, world):
    """Every rank holds the single-device gradient of the loss summed over the
    whole batch (the gradients all-reduced over `data`): the port's own at
    rtol 1e-4, atol 1e-5 (tests/test_sharding.py), JAX's within 1e-4 of max
    |ref| (the trainable STFT's tolerance in tests/test_torch_training.py;
    d|X| = re/|X| is ill-conditioned at near-zero bins, so element-wise
    tolerances hold only between routes of one arithmetic)."""
    import jax

    x = _x(5, 8, 2048)
    layer = jf.STFT(n_fft=256, hop_length=64, trainable=True, output_format="Magnitude",
                    verbose=False)
    want = jax.grad(lambda p: jnp.sum(layer.apply(p, x, output_format="Magnitude")))(
        layer.trainable_params())
    mine = tf.STFT(n_fft=256, hop_length=64, trainable=True, output_format="Magnitude",
                   verbose=False, device="cpu")
    single = _one_thread(lambda: torch.autograd.grad(mine(x).sum(), [mine.wsin, mine.wcos]))
    for p in worlds[world]:
        for k, g in zip(("wsin", "wcos"), single):
            np.testing.assert_allclose(p[f"dp_grad_{k}"], _np(g), rtol=1e-4, atol=1e-5)
            assert _rel(p[f"dp_grad_{k}"], want[k]) <= REL


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_step_under_batch_sharding(worlds, world):
    x = _x(40, 8, 128 * 40)
    got = _gather_data(worlds[world], "dp_coord", "dp_stream")
    s = jstreaming.StreamingSTFT(n_fft=512, hop_length=128)
    want = np.concatenate([np.asarray(f) for f in s.stream(x, 128 * 8)], axis=2)
    mine = tf.STFT(n_fft=512, hop_length=128, center=False, output_format="Magnitude",
                   verbose=False, device="cpu")(x)
    assert _rel(got, want) <= REL
    np.testing.assert_allclose(got, _np(mine), atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_input_helpers(worlds, world):
    for p in worlds[world]:
        assert p["mesh_error_None_3"] and p["mesh_error_1_1"]
        assert bool(p[f"mesh_error_{world}_2"])
        assert p["host_batches_equal"] and p["host_batch_bad_axis_raises"]


@pytest.fixture(scope="module")
def bank_refs():
    """Per bank case: the port's single-device output, JAX's, the bin count."""
    jlayers = {"cqt1992v2": lambda: jf.CQT1992v2(verbose=False, **CQT_KW),
               "vqt": lambda: jf.VQT(gamma=2, verbose=False, **CQT_KW),
               "cqt2010v2": lambda: jf.CQT2010v2(verbose=False, **CQT_KW),
               "cqt1992_frozen": lambda: jf.CQT1992(**{**CQT_KW, "hop_length": 256})}
    kw = dict(output_format="Magnitude", normalization_type="librosa")
    return {name: (_np(layer(x, **kw)), np.asarray(jlayers[name]()(x, **kw)),
                   layer.lenghts.shape[0])
            for name, layer, x in _bank_layers(tf)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["cqt1992v2", "vqt", "cqt2010v2", "cqt1992_frozen"])
def test_bank_sharded_matches_single_device(worlds, bank_refs, world, name):
    """Each rank computes the bins of its bank rows; together they equal the
    single-device output (tests/test_sharding.py: rtol 1e-5, atol 1e-6; the
    frozen CQT1992 at atol 1e-5)."""
    single, want, n_bins = bank_refs[name]
    got = _gather_bank(worlds[world], f"bank_{name}")
    np.testing.assert_allclose(got, single, rtol=1e-5,
                               atol=1e-5 if name == "cqt1992_frozen" else 1e-6)
    assert _rel(got, want) <= REL
    for p in worlds[world]:
        assert len(p[f"bank_{name}_rows"]) == n_bins // 2


@pytest.mark.parametrize("world", WORLDS)
def test_shard_kernel_bank_layout(worlds, world):
    assert all(p["layout_ok"] for p in worlds[world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt,norm", CONTRACTION)
def test_contraction_sharded_cqt1992(worlds, world, fmt, norm):
    """Fourier bins over `model`, partial products summed by all_reduce:
    every rank holds the single-device output (tests/test_sharding.py: rtol
    1e-4, atol 1e-4 against JAX)."""
    i = CONTRACTION.index((fmt, norm))
    x = _x(12 + (i > 0), 2, 8192)
    want = np.asarray(jf.CQT1992(trainable_CQT=True, **C1992_KW)(
        x, output_format=fmt, normalization_type=norm))
    single = _np(tf.CQT1992(trainable_CQT=True, device="cpu", **C1992_KW)(
        x, output_format=fmt, normalization_type=norm))
    for p in worlds[world]:
        got = p[f"contraction_{fmt}_{norm}"]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5 * np.abs(single).max())


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_stft_matches_single_device(worlds, world):
    """The ranks' frames, the boundaries between ranks included, equal the
    single-device center=False STFT of the halo-padded signal."""
    x = _x(3, 2, world * 2048)
    want = np.asarray(jf.STFT(n_fft=512, hop_length=128, center=False, output_format="Complex",
                              verbose=False)(np.pad(x, ((0, 0), (0, 384)))))
    parts = sorted(worlds[world], key=lambda p: int(p["dp_coord"][0]))
    real = np.concatenate([p["time_real"] for p in parts], axis=2)
    imag = np.concatenate([p["time_imag"] for p in parts], axis=2)
    np.testing.assert_allclose(real, want[..., 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(imag, -want[..., 1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_round_trip(worlds, world):
    """istft(stft(x)) across ranks: the interior returns x (rtol 1e-3, atol
    1e-4) and equals the single-device iSTFT of the same frames."""
    x = _x(4, 1, world * 1024)
    parts = sorted(worlds[world], key=lambda p: int(p["dp_coord"][0]))
    rec = np.concatenate([p["time_round_trip"] for p in parts], axis=1)
    np.testing.assert_allclose(rec[:, 512:-512], x[:, 512:-512], rtol=1e-3, atol=1e-4)
    X = np.asarray(jf.STFT(n_fft=512, hop_length=128, center=False, output_format="Complex",
                           verbose=False)(np.pad(x, ((0, 0), (0, 384)))))
    want = np.asarray(jf.iSTFT(n_fft=512, hop_length=128, center=False, verbose=False)(
        X, onesided=True))[:, :x.shape[1]]
    np.testing.assert_allclose(rec[:, 512:-512], want[:, 512:-512],
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["1992v2", "2010v2"])
def test_bank_sharded_inverse_matches_single_device(worlds, world, family):
    """Dual-bank rows over `model`, the partial signals summed by all_reduce:
    the single-device inverse within 1e-5 of max |ref| (tests/test_sharding.py),
    JAX's within 1e-4."""
    layer = dict(_inverse_layers(tf))[family]
    jlayer = (jf.CQT1992v2(output_format="Complex", verbose=False, **INV_KW)
              if family == "1992v2" else
              jf.CQT2010v2(bins_per_octave=12, earlydownsample=False, output_format="Complex",
                           verbose=False, **INV_KW))
    x = _x(9, 4, 8192)
    single = _np(layer.inverse(layer(x)))
    want = np.asarray(jlayer.inverse(jlayer(x)))
    got = _gather_data(worlds[world], "tp_coord", f"inverse_{family}", model=0)
    np.testing.assert_allclose(got, single, atol=1e-5 * np.abs(single).max())
    assert _rel(got, want) <= REL
    for p in worlds[world]:  # both model ranks hold the reduced signal
        d = int(p["tp_coord"][0])
        rows = got.shape[0] // (world // 2)
        np.testing.assert_array_equal(p[f"inverse_{family}"], got[d * rows:(d + 1) * rows])


def test_sharded_checkpoint_restores_onto_fewer_ranks(worlds):
    """A bank sharded over 4 ranks, saved with torch.distributed.checkpoint,
    restored onto a (1, 2) mesh of 2 ranks: exact values in the new layout,
    and the bank-sharded forward from them equals the single-device one."""
    parts = worlds[2]
    assert all(p["restored_ok"] for p in parts)
    x = _x(7, 4, 16384)
    got = np.zeros((4, 48, parts[0]["restored_apply"].shape[-1]), np.float32)
    for p in parts:
        got[:, p["restored_apply_rows"]] = p["restored_apply"]
    single = _np(tf.CQT1992v2(verbose=False, device="cpu", **CQT_KW)(x))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    assert _rel(got, jf.CQT1992v2(verbose=False, **CQT_KW)(x)) <= REL


def test_distributed_initialize_single_process_noop():
    import torch.distributed as dist

    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        parallel.distributed_initialize()
        assert not dist.is_initialized()
    finally:
        os.environ.update(env)


def test_distributed_initialize_propagates_explicit_errors(tmp_path):
    """An explicitly configured group that cannot form raises."""
    import torch.distributed as dist

    with pytest.raises((ValueError, RuntimeError, AssertionError)):
        parallel.distributed_initialize(backend="gloo", init_method=f"file://{tmp_path}/init",
                                        world_size=1, rank=3)
    assert not dist.is_initialized()


def test_parallel_has_every_public_name_of_the_jax_package():
    assert set(jparallel.__all__) == set(parallel.__all__)
    for name in ("bank_sharded_inverse", "contraction_sharded_cqt1992", "shard_kernel_bank"):
        assert hasattr(parallel.bank, name) and hasattr(jparallel.bank, name)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh()
