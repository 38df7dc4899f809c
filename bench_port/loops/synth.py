"""Synthesis streaming: ``streams`` streams step in lockstep, ``frames_per_step``
spectral frames each per step, one step in flight at a time. A stream lasts
``stream_seconds`` (whole steps), its last step ends with the stream's
``flush``, then all are re-primed with the next streams of a seeded pool.

Set-up builds the port's stream first (a port that lacks the entry's
arguments fails there, at once), then makes the pool: seeded clips, whose
``center=False`` STFT (the reference's own) is each stream's spectra, laid
out so that each step's spectra lie together; the clips are then dropped.
Each step is timed as the analysis stream's are (``stream._Clock``), from the
hand-off of its spectra (re-priming included) to its samples being ready.
The mix gives ``streams``, ``frames_per_step``, ``stream_seconds``, ``pool``,
``sample`` (streams kept for the check, whole or as far as the window's end
cut them) and optionally ``signal``; the configuration's ``entries.synth``
names the port's synthesis stream and its arguments.

The faults of this loop (``FAULTS``, planted by :func:`plant` for a ``with``
block):

- ``altered``: one sample of each step's output moved by 1% of the output's
  largest magnitude;
- ``unchanged``: the step returns the state it was given;
- ``untrimmed``: the stream is built with ``padding="none"`` whatever the
  configuration asks.
"""
from __future__ import annotations

import collections
import time

import torch

from .. import signals
from ..faults import _alter, patched
from .common import (Reservoir, entry, entry_args, rel_l2, release, span, sync,
                     use_precision, worst)
from .stream import _Clock

FAULTS = ("altered", "unchanged", "untrimmed")


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.settings = s = config["settings"]
        self.entry = config["entries"]["synth"]
        self.precision = config["precision"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.reference = reference
        self.streams = traffic["streams"]
        self.frames_per_step = traffic["frames_per_step"]
        per_step = self.frames_per_step * s["hop_length"]
        self.steps = int(traffic["stream_seconds"] * s["sr"]) // per_step
        self.frames = self.steps * self.frames_per_step
        # the clip whose center=False STFT has exactly ``frames`` frames
        self.length = (self.frames - 1) * s["hop_length"] + s["n_fft"]

    def setup(self) -> None:
        use_precision(self.precision)
        self.sut = entry(self.entry["call"])(
            **entry_args(self.entry, self.settings, self.device))
        gen = signals.generator(self.seed, self.device)
        self.spectra = []
        for _ in range(self.traffic["pool"]):
            x = signals.clips(gen, self.streams, self.length, self.settings["sr"],
                              self.traffic.get("signal"))
            spec = self.reference.requests(self.settings, x)
            del x
            b, f, _, ri = spec.shape
            # (steps, streams, F, frames_per_step, 2): each step's spectra lie together
            self.spectra.append(spec.reshape(b, f, self.steps, self.frames_per_step, ri)
                                .permute(2, 0, 1, 3, 4).contiguous())
            del spec
        self.clock = _Clock(self.device)
        self.sample = Reservoir(self.traffic["sample"], self.seed)
        self.block = 0
        # every step's shape, and as many live streams as the sample holds
        held = [self._stream(p % len(self.spectra)) for p in range(self.sample.size + 1)]
        sync(self.device)
        del held

    def _stream(self, p):
        state = self.sut.init_state(self.streams)
        outs = []
        for s in range(self.steps):
            state, y = self.sut.step(state, self.spectra[p][s])
            outs.append(y)
        outs.append(self.sut.flush(state))
        return outs

    def run(self, seconds: float, keep: bool = True, span_name: str | None = None):
        n, lat = 0, []
        shapes = collections.Counter()
        start = time.perf_counter()
        done = False
        while not done:
            block = self.block
            spectra = self.spectra[block % len(self.spectra)]
            outs, state = [], None
            for s in range(self.steps):
                last = s == self.steps - 1
                self.clock.start()
                with span(span_name):
                    if s == 0:
                        state = self.sut.init_state(self.streams)
                    state, y = self.sut.step(state, spectra[s])
                    emitted = [y]
                    if last:
                        emitted.append(self.sut.flush(state))
                    lat.append(self.clock.stop())
                shapes[(self.streams, self.frames_per_step,
                        sum(e.shape[-1] for e in emitted), s == 0, last)] += 1
                outs += emitted
                n += 1
                if time.perf_counter() - start >= seconds:
                    done = True
                    break
            if keep:
                self.sample.offer(block, (s + 1, outs))
            self.block += 1
        wall = time.perf_counter() - start
        return {"attempted": n, "seconds": wall, "latencies_ms": lat, "shapes": shapes}

    def release(self) -> None:
        del self.sut
        release(self.device)

    def readings(self, control: bool = False) -> dict:
        """The worst stream's relative L2 error over what it emitted, of the
        kept streams against the reference's ``ISTFT(padding="same")`` of
        their whole spectra (or of the control in their place): a whole
        stream over all its samples, a stream that the window's end cut over
        the samples its steps emitted. Any difference in length reads
        ``inf``, and so does a check that kept nothing."""
        s = self.settings
        pad = self.reference.pad(s)
        errors = []
        for block, (steps, outs) in self.sample.kept:
            spectra = self.spectra[block % len(self.spectra)]
            # (streams, F, frames, 2), the stream's frames in order
            spec = spectra.permute(1, 2, 0, 3, 4).reshape(
                self.streams, spectra.shape[2], self.frames, spectra.shape[-1])
            want = self.reference.synthesis(s, spec)
            if steps < self.steps:
                want = want[:, :max(0, steps * self.frames_per_step * s["hop_length"] - pad)]
            got = (self.reference.synthesis(s, spec, control=True)[:, :want.shape[1]]
                   if control else torch.cat(outs, dim=-1))
            errors.append(rel_l2(got, want))
        return {"rel_l2": worst(errors) if errors else float("inf")}


def plant(fault: str, entry_cfg: dict):
    """A context in which the synthesis stream of ``entry_cfg`` carries
    ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"a synth cell has no fault {fault!r}")
    cls = entry(entry_cfg["call"])
    if fault == "untrimmed":
        def make(init):
            def untrimmed(self, *args, **kw):
                init(self, *args, **{**kw, "padding": "none"})
            return untrimmed
        return patched(cls, "__init__", make)

    def make(step):
        def faulty(self, state, spectra):
            new_state, y = step(self, state, spectra)
            if fault == "unchanged":
                return state, y
            return new_state, (_alter(y) if y.numel() else y)
        return faulty
    return patched(cls, "step", make)
