"""Training: a closed loop of SGD steps of the trainable front end and its
head, one batch of clips at a time from a seeded pool, each step ending when
its new parameters are ready.

Set-up makes the model, loads the initial parameters the reference made
from the seed, and drives the first three steps through the window's own
step on three distinct batches; the check compares the first of them.
The window continues from the same model and parameters. The mix gives
``batch``, ``clip_seconds``, ``pool`` and optionally ``signal``; the
configuration's ``entries.train`` names the model, the step and the model's
arguments, and its ``train`` block the classes and the learning rate.
"""
from __future__ import annotations

import collections
import statistics
import time

import torch

from .. import signals
from .common import entry, entry_args, release, span, sync, use_precision, worst

#: the steps that set-up drives, on distinct batches, before the window
CHECKED_STEPS = 3
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the gradient gap (it moves by round-off)
LEAF_FLOOR = 1e-3


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.settings = {**config["settings"], **config["train"]}
        self.entry = config["entries"]["train"]
        self.precision = config["precision"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.reference = reference
        sr = self.settings["sr"]
        self.batch = traffic["batch"]
        self.length = round(traffic["clip_seconds"] * sr)
        self.audio_per_step = self.batch * self.length / sr
        self.lr = self.settings["lr"]

    def setup(self) -> None:
        use_precision(self.precision)
        gen = signals.generator(self.seed, self.device)
        n_pool = self.traffic["pool"]
        if n_pool < CHECKED_STEPS:
            raise ValueError(f"a train mix needs a pool of {CHECKED_STEPS} batches or more")
        self.pool = [signals.clips(gen, self.batch, self.length, self.settings["sr"],
                                   self.traffic.get("signal"))
                     for _ in range(n_pool)]
        self.labels = [signals.labels(gen, self.batch, self.settings["n_classes"])
                       for _ in range(n_pool)]
        self.start = self.reference.init_params(self.settings, self.settings, gen, self.device)
        self.model = entry(self.entry["model"])(
            **entry_args(self.entry, self.settings, self.device))
        self.model.load_state_dict(self.start, strict=True)
        self.step = entry(self.entry["step"])
        self.params = dict(self.model.init_params)
        self.losses, self.states = [], []
        for i in range(CHECKED_STEPS):
            loss, self.params = self.step(self.model, self.params, self.pool[i],
                                          self.labels[i], self.lr)
            self.losses.append(loss)
            self.states.append(self.params)
        sync(self.device)
        self.steps = CHECKED_STEPS

    def run(self, seconds: float, keep: bool = True, span_name: str | None = None):
        n, host = 0, 0.0
        start = time.perf_counter()
        while True:
            i = self.steps % len(self.pool)
            with span(span_name):
                t0 = time.perf_counter()
                _, self.params = self.step(self.model, self.params, self.pool[i],
                                           self.labels[i], self.lr)
                host += time.perf_counter() - t0
                sync(self.device)
            self.steps += 1
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        wall = time.perf_counter() - start
        return {"attempted": n, "seconds": wall, "audio_s": n * self.audio_per_step,
                "host_s": host, "shapes": collections.Counter({(self.batch, self.length): n})}

    def release(self) -> None:
        del self.model, self.params
        release(self.device)

    def readings(self, control: bool = False) -> dict:
        """The check's numbers: the relative gap of the first step's loss,
        and the worst leaf's gap between the program's and the reference's
        norms of the first gradient (from the state after one step), over
        the reference's norm of that leaf or of the median leaf, whichever
        is larger. Leaves whose reference gradient is under
        :data:`LEAF_FLOOR` of the median leaf's are left out. The later
        steps' losses and the change after three steps are not compared:
        from the second step on, the log of the clamped mel projection makes
        even two plain references (float32 and float64) part by 10-70%
        (``PERF.md``)."""
        batches = [(self.pool[i], self.labels[i]) for i in range(CHECKED_STEPS)]
        ref_losses, ref_states = self.reference.train(self.settings, self.settings,
                                                      self.start, batches[:1])
        if control:
            losses, states = self.reference.train(self.settings, self.settings,
                                                  self.start, batches[:1], control=True)
        else:
            losses, states = [float(v) for v in self.losses], self.states

        def grad_norms(state):
            return {k: float(torch.linalg.vector_norm(state[k].detach().double()
                                                      - self.start[k].double())) / self.lr
                    for k in self.start}

        want, got = grad_norms(ref_states[0]), grad_norms(states[0])
        mid = statistics.median(want.values())
        leaves = [k for k, v in want.items() if v >= LEAF_FLOOR * mid]
        return {"first_loss_gap": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
                "grad_norm_gap": worst(abs(got[k] - want[k]) / max(want[k], mid)
                                       for k in leaves)}
