"""Trainable-frontend audio classifier (flagship end-to-end model)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._spans import span
from ..features.base import adopt_state, to_float32
from ..features.mel import MelSpectrogram


class SpectrogramClassifier(nn.Module):
    """MelSpectrogram (trainable STFT + mel bases) -> log -> temporal
    mean-pool -> linear head.

    The state is flat, with the JAX model's ``init_params`` keys
    (``wsin``, ``wcos``, ``mel_basis``, ``head_w``, ``head_b``). ``forward``
    and ``loss_fn`` take a params dict like the JAX model's; ``None`` means
    the module's own tensors; :func:`train_step` differentiates through
    them. ``device=None`` means CUDA; pass
    ``device="cpu"`` for the CPU.
    """

    def __init__(
        self,
        n_classes: int = 10,
        sr: float = 16000,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_mels: int = 64,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        frontend = MelSpectrogram(
            sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            trainable_mel=True, trainable_STFT=True, verbose=False,
            device=device,
        )
        # held, not registered: the frontend's tensors are this model's own
        # flat state (the JAX model's init_params keys), shared not copied
        object.__setattr__(self, "frontend", frontend)
        adopt_state(self, frontend)
        dev = frontend.device
        rng = np.random.RandomState(seed)
        head_w = (rng.randn(n_mels, n_classes) / np.sqrt(n_mels)).astype(np.float32)
        self.head_w = nn.Parameter(to_float32(head_w, dev))
        self.head_b = nn.Parameter(torch.zeros(n_classes, dtype=torch.float32, device=dev))

    @property
    def init_params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, params, x):
        """(B, L) waveforms -> (B, n_classes) logits."""
        p = self.init_params
        if params:
            p.update(params)
        mel = self.frontend._forward(p, to_float32(x, self.head_w.device))
        # clamp before the log: once the mel basis trains, projections can go
        # negative and an unguarded log NaNs the whole optimization
        feats = torch.mean(torch.log(torch.clamp(mel, min=0.0) + 1e-6), dim=-1)
        return feats @ p["head_w"] + p["head_b"]

    def loss_fn(self, params, x, labels):
        logits = self.forward(params, x)
        labels = torch.as_tensor(labels, device=logits.device).long()
        return F.cross_entropy(logits, labels)


def train_step(model: SpectrogramClassifier, params, x, labels, lr=1e-3):
    """One SGD step, the JAX package's ``train_step``: returns ``(loss,
    new_params)`` with ``new_params[k] = params[k] - lr * dloss/dparams[k]``.
    A pure function of ``params``: the gradients go to fresh leaves, so no
    tensor of the model or of ``params`` is changed and no ``.grad`` is
    written. While a profiler runs, the step is the span
    ``nnaudio.train.step`` around ``.forward`` (the loss), ``.backward``
    (the gradients) and ``.update`` (the new parameters)."""
    with span("nnaudio.train.step"):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            with span("nnaudio.train.forward"):
                loss = model.loss_fn(leaves, x, labels)
            with span("nnaudio.train.backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()))
        with span("nnaudio.train.update"):
            new_params = {k: (v - lr * g).detach()
                          for (k, v), g in zip(leaves.items(), grads)}
        return loss.detach(), new_params
