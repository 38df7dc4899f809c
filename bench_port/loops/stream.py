"""Streaming: ``streams`` streams step in lockstep, one chunk each per step,
one step in flight at a time. A stream lasts ``stream_seconds`` (whole
chunks), then all are re-primed with the next streams of a seeded pool.

Each step is timed on the device's clock by CUDA events, from the hand-off
of its chunks (re-priming included) to its output being ready; on the CPU,
where there are no events, by the host's clock. The mix gives ``streams``,
``chunk``, ``stream_seconds``, ``pool``, ``sample`` (whole streams kept for
the check) and optionally ``signal``; the configuration's
``entries.stream`` names the port's streaming class and its arguments.
"""
from __future__ import annotations

import collections
import time

import torch

from .. import signals
from .common import (Reservoir, entry, entry_args, rel_l2, release, span,
                     sync, use_precision, worst)


class _Clock:
    """Milliseconds of what runs between ``start`` and ``stop``."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return 1e3 * (time.perf_counter() - self.t0)


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.settings = config["settings"]
        self.entry = config["entries"]["stream"]
        self.precision = config["precision"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.reference = reference
        sr = self.settings["sr"]
        self.streams = traffic["streams"]
        self.chunk = traffic["chunk"]
        self.steps = int(traffic["stream_seconds"] * sr) // self.chunk
        self.length = self.steps * self.chunk

    def setup(self) -> None:
        use_precision(self.precision)
        gen = signals.generator(self.seed, self.device)
        self.signals = [signals.clips(gen, self.streams, self.length, self.settings["sr"],
                                      self.traffic.get("signal"))
                        for _ in range(self.traffic["pool"])]
        # (steps, streams, chunk): each step's chunks lie together
        self.chunks = [x.reshape(self.streams, self.steps, self.chunk).transpose(0, 1).contiguous()
                       for x in self.signals]
        self.sut = entry(self.entry["call"])(
            **entry_args(self.entry, self.settings, self.device))
        self.clock = _Clock(self.device)
        self.sample = Reservoir(self.traffic["sample"], self.seed)
        self.block = 0
        # every step's shape, and as many live streams as the sample holds
        held = [self._stream(p % len(self.chunks)) for p in range(self.sample.size + 1)]
        sync(self.device)
        del held

    def _stream(self, p):
        state = self.sut.init_state(self.streams)
        outs = []
        for s in range(self.steps):
            state, y = self.sut.step(state, self.chunks[p][s])
            outs.append(y)
        return outs

    def run(self, seconds: float, keep: bool = True, span_name: str | None = None):
        n, host, lat = 0, 0.0, []
        shapes = collections.Counter()
        start = time.perf_counter()
        done = False
        while not done:
            block = self.block
            chunks = self.chunks[block % len(self.chunks)]
            outs, state = [], None
            for s in range(self.steps):
                self.clock.start()
                with span(span_name):
                    t0 = time.perf_counter()
                    if s == 0:
                        state = self.sut.init_state(self.streams)
                    carried = state.primed
                    state, y = self.sut.step(state, chunks[s])
                    host += time.perf_counter() - t0
                    lat.append(self.clock.stop())
                shapes[(self.streams, self.chunk, carried)] += 1
                outs.append(y)
                n += 1
                if time.perf_counter() - start >= seconds:
                    done = True
                    break
            if keep and len(outs) == self.steps:
                self.sample.offer(block, outs)
            self.block += 1
        wall = time.perf_counter() - start
        return {"attempted": n, "seconds": wall,
                "audio_s": n * self.streams * self.chunk / self.settings["sr"],
                "host_s": host, "latencies_ms": lat, "shapes": shapes}

    def release(self) -> None:
        del self.sut
        release(self.device)

    def readings(self, control: bool = False) -> dict:
        """The worst stream's relative L2 error over its whole output, of the
        kept streams against the offline ``center=False`` reference of their
        signals (or of the control in their place)."""
        errors = []
        for block, outs in self.sample.kept:
            x = self.signals[block % len(self.signals)]
            want = self.reference.stream(self.settings, x)
            got = (self.reference.stream(self.settings, x, control=True) if control
                   else torch.cat(outs, dim=-1))
            errors.append(rel_l2(got, want))
        return {"rel_l2": worst(errors)}
