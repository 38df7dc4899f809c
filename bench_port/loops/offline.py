"""Offline extraction: a closed loop of one request at a time, each a batch
of clips from a seeded pool, each ending when its features are ready.

The traffic mix gives ``batch``, ``clip_seconds``, ``pool`` (distinct
batches the window cycles through), ``sample`` (requests kept for the check)
and optionally ``signal``; the configuration's ``entries.offline`` names the
port's transform and its arguments.
"""
from __future__ import annotations

import collections
import time

import torch

from .. import signals
from .common import (Reservoir, entry, entry_args, rel_l2, release, span,
                     sync, use_precision, worst)


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.settings = config["settings"]
        self.entry = config["entries"]["offline"]
        self.precision = config["precision"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.reference = reference
        sr = self.settings["sr"]
        self.batch = traffic["batch"]
        self.length = round(traffic["clip_seconds"] * sr)
        self.audio_per_call = self.batch * self.length / sr

    def setup(self) -> None:
        use_precision(self.precision)
        gen = signals.generator(self.seed, self.device)
        self.pool = [signals.clips(gen, self.batch, self.length, self.settings["sr"],
                                   self.traffic.get("signal"))
                     for _ in range(self.traffic["pool"])]
        self.sut = entry(self.entry["call"])(
            **entry_args(self.entry, self.settings, self.device))
        self.sample = Reservoir(self.traffic["sample"], self.seed)
        # every shape of the window, and as many live answers as the sample
        # holds, so the window allocates nothing new
        held = [self.call(self.pool[i % len(self.pool)])
                for i in range(self.sample.size + 2)]
        sync(self.device)
        del held

    def call(self, x):
        with torch.no_grad():
            return self.sut(x)

    def run(self, seconds: float, keep: bool = True, span_name: str | None = None):
        """Requests until ``seconds`` have passed; the window's counts."""
        n, host = 0, 0.0
        start = time.perf_counter()
        while True:
            x = self.pool[n % len(self.pool)]
            with span(span_name):
                t0 = time.perf_counter()
                y = self.call(x)
                host += time.perf_counter() - t0
                sync(self.device)
            if keep:
                self.sample.offer(n, y)
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        wall = time.perf_counter() - start
        return {"attempted": n, "seconds": wall, "audio_s": n * self.audio_per_call,
                "host_s": host, "shapes": collections.Counter({(self.batch, self.length): n})}

    def release(self) -> None:
        del self.sut
        release(self.device)

    def readings(self, control: bool = False) -> dict:
        """The check's numbers: the worst clip's relative L2 error of the
        kept answers against the reference (or of the control in their
        place)."""
        errors = []
        for index, y in self.sample.kept:
            x = self.pool[index % len(self.pool)]
            want = self.reference.offline(self.settings, x)
            got = self.reference.offline(self.settings, x, control=True) if control else y
            errors.append(rel_l2(got, want))
        return {"rel_l2": worst(errors)}
