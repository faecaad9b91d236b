"""Silero VAD v6 in PyTorch — batched voice-activity detection (port of
whisperlivekit_tpu/audio/vad_jax.py).

Weight-exact port of the Silero .jit graph's 16 kHz tower (weights read
from the jit state_dict):

    [context(64) | frame(512)] → reflect-pad(64) → STFT (258×256, hop 128)
    → magnitude[129, 4] → conv(129→128, k3) ReLU → conv(128→64, k3, s2)
    → conv(64→64, k3, s2) → conv(64→128, k3) → LSTMCell(128) →
    conv1x1(128→1) → sigmoid

One ``vad_step`` scores B sessions' frames at once on the module's device;
the state (h, c, context) is an explicit ``VADState`` of tensors.
``audio/vad_batched.py`` keeps a pool of such states on the device and
batches every session's 32 ms tick into one step.

Precision: the STFT and the four convolutions are written as unfolds and
matrix products, and the LSTM and the head are matrix products, so
everything runs under PyTorch's matmul default (full f32 on CUDA unless
``torch.backends.cuda.matmul.allow_tf32`` is set); cuDNN's TF32 default for
convolutions does not apply.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vad import find_silero_jit

FRAME = 512
CONTEXT = 64
HIDDEN = 128
N_FFT = 256
HOP = 128
ENCODER = ((129, 128, 1), (128, 64, 2), (64, 64, 2), (64, 128, 1))  # (in, out, stride), kernel 3, padding 1

# the jit state_dict's keys → SileroVAD's
_JIT_KEYS = {"_model.stft.forward_basis_buffer": "stft_basis",
             **{f"_model.encoder.{i}.reparam_conv.{k}": f"enc.{i}.{k}" for i in range(4) for k in ("weight", "bias")},
             **{f"_model.decoder.rnn.{k}": f"lstm.{k}" for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")},
             "_model.decoder.decoder.2.weight": "head.weight", "_model.decoder.decoder.2.bias": "head.bias"}


class VADState(NamedTuple):
    h: torch.Tensor        # [B, 128]
    c: torch.Tensor        # [B, 128]
    context: torch.Tensor  # [B, 64]


def init_state(batch: int, device) -> VADState:
    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(batch, n, dtype=torch.float32, device=device)

    return VADState(h=zeros(HIDDEN), c=zeros(HIDDEN), context=zeros(CONTEXT))


class SileroVAD(nn.Module):
    """The 16 kHz tower's weights: the STFT basis [258, 1, 256], the four
    encoder convolutions (OIH), the LSTM cell ([512, 128] in i, f, g, o
    order) and the 1x1 head. No gradients; ``vad_step`` is the forward."""

    def __init__(self):
        super().__init__()
        self.register_buffer("stft_basis", torch.zeros(2 * (N_FFT // 2 + 1), 1, N_FFT))
        self.enc = nn.ModuleList(nn.Conv1d(i, o, 3, stride=s, padding=1) for i, o, s in ENCODER)
        self.lstm = nn.LSTMCell(HIDDEN, HIDDEN)
        self.head = nn.Conv1d(HIDDEN, 1, 1)
        self.requires_grad_(False)


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv`` (kernel 3, padding 1) over x [B, C, L] as an unfold and one
    matrix product: [B, L', C·3] @ [C·3, O]."""
    b, c, _ = x.shape
    cols = F.pad(x, (1, 1)).unfold(2, 3, conv.stride[0])                     # [B, C, L', 3]
    cols = cols.permute(0, 2, 1, 3).reshape(b, -1, c * 3)                    # [B, L', C·3]
    y = torch.matmul(cols, conv.weight.reshape(conv.out_channels, c * 3).t())  # [B, L', O]
    return (y + conv.bias).transpose(1, 2)                                   # [B, O, L']


@torch.no_grad()
def vad_step(model: SileroVAD, state: VADState, frames: torch.Tensor) -> Tuple[torch.Tensor, VADState]:
    """frames [B, 512] float32 → (probs [B], new state)."""
    x = torch.cat([state.context, frames], dim=1)                   # [B, 576]
    x = F.pad(x, (0, CONTEXT), mode="reflect")                      # [B, 640]

    windows = x.unfold(1, N_FFT, HOP)                               # [B, 4, 256]
    spect = torch.matmul(windows, model.stft_basis[:, 0, :].t())    # [B, 4, 258]
    cut = N_FFT // 2 + 1
    real, imag = spect[..., :cut], spect[..., cut:]
    h = torch.sqrt(real * real + imag * imag).transpose(1, 2)       # [B, 129, 4]

    for conv in model.enc:
        h = F.relu(_conv1d(h, conv))                                # → [B, 128, 1]

    xt = h[:, :, 0]                                                 # [B, 128]
    lstm = model.lstm
    gates = F.linear(xt, lstm.weight_ih, lstm.bias_ih) + F.linear(state.h, lstm.weight_hh, lstm.bias_hh)
    i, f, g, o = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
    hh = torch.sigmoid(o) * torch.tanh(c)

    # head = dropout (inference no-op) → ReLU → conv1x1 → sigmoid
    logit = torch.matmul(F.relu(hh), model.head.weight[0, :, 0]) + model.head.bias[0]
    prob = torch.sigmoid(logit)                                     # [B]

    return prob, VADState(h=hh, c=c, context=frames[:, -CONTEXT:])


def load_params(model_path: Optional[str] = None, device=None) -> SileroVAD:
    """The Silero .jit 16 kHz tower as a ``SileroVAD`` on ``device``
    (None: the card, raising without CUDA). Raises ``FileNotFoundError``
    when no ``silero_vad.jit`` is found (``find_silero_jit``)."""
    from ..engine.core import default_device

    device = torch.device(device) if device is not None else default_device()
    path = find_silero_jit(model_path)
    if path is None:
        raise FileNotFoundError("silero_vad.jit not found")
    sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    model = SileroVAD()
    model.load_state_dict({ours: sd[theirs].float() for theirs, ours in _JIT_KEYS.items()})
    return model.to(device)


def params_from_jax(tree: Dict, device="cpu") -> SileroVAD:
    """The JAX ``load_params`` pytree (numpy leaves) as a ``SileroVAD``."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {"stft_basis": t(tree["stft_basis"]),
          **{f"enc.{i}.{k}": t(tree["enc"][i][j]) for i in range(4) for k, j in (("weight", "w"), ("bias", "b"))},
          **{f"lstm.{k}": t(tree["lstm"][j]) for k, j in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))},
          "head.weight": t(tree["head"]["w"]), "head.bias": t(tree["head"]["b"])}
    model = SileroVAD()
    model.load_state_dict(sd)
    return model.to(device)


def _device_of(model: SileroVAD) -> torch.device:
    return model.stft_basis.device


class SileroTorchVAD:
    """Frame-model wrapper compatible with audio.vad.VADIterator."""

    def __init__(self, model_path: Optional[str] = None, params: Optional[SileroVAD] = None, device=None):
        self.params = params if params is not None else load_params(model_path, device)
        self.device = _device_of(self.params)
        self.reset_states()

    def reset_states(self) -> None:
        self.state = init_state(1, self.device)

    def new_session(self) -> "SileroTorchVAD":
        return SileroTorchVAD(params=self.params)

    def __call__(self, frame: np.ndarray, sr: int = 16000) -> float:
        x = torch.as_tensor(np.asarray(frame, np.float32), device=self.device)[None]
        prob, self.state = vad_step(self.params, self.state, x)
        return float(prob[0])


class BatchedSileroVAD:
    """Scheduler-scale VAD: one device step scores all sessions' 32 ms ticks."""

    def __init__(self, batch: int, model_path: Optional[str] = None, device=None):
        self.params = load_params(model_path, device)
        self.batch = batch
        self.state = init_state(batch, _device_of(self.params))

    def step(self, frames: np.ndarray) -> np.ndarray:
        """frames [B, 512] → probs [B]."""
        x = torch.as_tensor(np.asarray(frames, np.float32), device=_device_of(self.params))
        probs, self.state = vad_step(self.params, self.state, x)
        return probs.cpu().numpy()

    def reset_lane(self, lane: int) -> None:
        for t in self.state:
            t[lane].zero_()
