"""Inversion: a closed loop of one request at a time, each a batch of mel
spectrograms turned back into audio, each ending when the audio is ready.

Set-up makes a seeded pool of clips, their mels (by the reference's own Mel,
on the device) and, per pool entry, the initial phases (uniform, in cycles,
as librosa's ``griffinlim`` draws them); the clips are then dropped. Each
call hands the port one mel batch and its phases, so the program and the
reference start from the same phases. The mix gives ``batch``,
``clip_seconds``, ``n_iter``, ``n_iter_nnls``, ``pool`` (distinct batches
the window cycles through), ``sample`` (requests kept for the check) and
optionally ``signal``; the configuration's ``entries.invert`` names the
port's transform and its arguments.

The faults of this loop (``FAULTS``, planted by :func:`plant` on the
transform's ``forward`` for a ``with`` block):

- ``fewer_iterations``: Griffin-Lim runs one iteration fewer;
- ``nnls_step_fewer``: the NNLS takes one step fewer;
- ``bf16_carries``: the port's own ``iter_precision="default"``, whose
  Griffin-Lim carries are bfloat16 (the fused step, K4, on the card).

The generic ``altered`` (one output sample moved by 1% of the answer's
peak) is left out: against a reference that follows the program through
32 iterations of float32 rounding it reads below the limit, and so belongs
to no number of this check.
"""
from __future__ import annotations

import collections
import statistics

import torch

from .. import signals
from ..faults import patched
from ..work.counts import frames
from . import offline
from .common import Reservoir, entry, entry_args, rel_l2, sync, use_precision

FAULTS = ("fewer_iterations", "nnls_step_fewer", "bf16_carries")


class Loop(offline.Loop):
    """Offline's closed loop, its timing and its release; the request is an
    index into the pool of mels and phases."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.settings = config["settings"]
        self.entry = config["entries"]["invert"]
        self.precision = config["precision"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.reference = reference
        s = self.settings
        self.batch = traffic["batch"]
        self.length = round(traffic["clip_seconds"] * s["sr"])
        self.frames = frames(self.length, s["n_fft"], s["hop_length"], s["center"])
        self.n_iter, self.n_iter_nnls = traffic["n_iter"], traffic["n_iter_nnls"]
        self.shape = (self.batch, self.frames, self.n_iter, self.n_iter_nnls)

    def setup(self) -> None:
        use_precision(self.precision)
        s = self.settings
        gen = signals.generator(self.seed, self.device)
        self.mels, self.phases = [], []
        for _ in range(self.traffic["pool"]):
            x = signals.clips(gen, self.batch, self.length, s["sr"], self.traffic.get("signal"))
            self.mels.append(self.reference.offline(s, x))
        bins = s["n_fft"] // 2 + 1
        for _ in range(self.traffic["pool"]):
            self.phases.append(torch.rand(self.batch, bins, self.frames, generator=gen,
                                          device=self.device))
        self.sut = entry(self.entry["call"])(
            n_iter=self.n_iter, n_iter_nnls=self.n_iter_nnls,
            **entry_args(self.entry, self.settings, self.device))
        self.pool = list(range(self.traffic["pool"]))
        self.sample = Reservoir(self.traffic["sample"], self.seed)
        # the one shape of the window, and as many live answers as the
        # sample holds, so the window allocates nothing new
        held = [self.call(i % len(self.pool)) for i in range(self.sample.size + 2)]
        sync(self.device)
        self.audio_per_call = held[0].numel() / s["sr"]
        del held

    def call(self, i: int):
        with torch.no_grad():
            return self.sut(self.mels[i], rand_phase=self.phases[i])

    def run(self, seconds: float, keep: bool = True, span_name: str | None = None):
        """Offline's window over the pool's indices, its shapes keyed by
        :attr:`shape`."""
        counts = super().run(seconds, keep, span_name)
        counts["shapes"] = collections.Counter({self.shape: counts["attempted"]})
        return counts

    def readings(self, control: bool = False) -> dict:
        """The check's number: of the kept answers' clips, each clip's
        relative L2 error against the reference's inversion of the same mel
        from the same phases (or of the control in their place), the median
        clip's. Not the worst clip's: Griffin-Lim carries float32 rounding
        from iteration to iteration, and on a few clips in a hundred the
        rounding of either side grows tenfold or more, so the worst clip
        swings from seed to seed where the median clip holds (``PERF.md``).
        NaN where any clip reads NaN or nothing was kept."""
        errors = []
        for index, y in self.sample.kept:
            i = index % len(self.pool)
            args = (self.settings, self.mels[i], self.phases[i], self.n_iter, self.n_iter_nnls)
            want = self.reference.invert(*args)
            got = self.reference.invert(*args, control=True) if control else y
            errors += [rel_l2(got[j:j + 1], want[j:j + 1]) for j in range(want.shape[0])]
        if not errors or any(e != e for e in errors):
            return {"rel_l2_median": float("nan")}
        return {"rel_l2_median": statistics.median(errors)}


def plant(fault: str, entry_cfg: dict):
    """A context in which the transform of ``entry_cfg`` carries ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"an invert cell has no fault {fault!r}")
    cls = entry(entry_cfg["call"])

    def make(forward):
        def faulty(self, mel, **kw):
            gl = self.griffin_lim
            saved = self.n_iter_nnls, gl.n_iter, gl.iter_precision
            if fault == "fewer_iterations":
                gl.n_iter -= 1
            elif fault == "nnls_step_fewer":
                self.n_iter_nnls -= 1
            else:
                gl.iter_precision = "default"
            try:
                return forward(self, mel, **kw)
            finally:
                self.n_iter_nnls, gl.n_iter, gl.iter_precision = saved
        return faulty
    return patched(cls, "forward", make)
