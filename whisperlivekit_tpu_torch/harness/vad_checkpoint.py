"""A seeded stand-in for Silero VAD v6's ``silero_vad.jit``, for tests and
the GPU smoke: the real file is not in the repository and nothing is
downloaded.

    python -m whisperlivekit_tpu_torch.harness.vad_checkpoint --out DIR --seed N

writes ``DIR/silero_vad.jit``, a TorchScript module in Silero v6's 16 kHz
layout: the state_dict keys that both packages' ``load_params`` read
(``_model.stft.forward_basis_buffer``, a Hann-windowed 256-point DFT basis
``[258, 1, 256]``; ``_model.encoder.{0..3}.reparam_conv.{weight,bias}``;
``_model.decoder.rnn.{weight_ih,weight_hh,bias_ih,bias_hh}``, an
``LSTMCell(128, 128)``; ``_model.decoder.decoder.2.{weight,bias}``, the 1x1
head), and ``forward(x, sr) -> prob [B, 1]`` over buffers holding h, c and
the 64-sample context, with an exported ``reset_states()``. So
``SileroJITVAD`` runs it on the host and ``load_params`` converts it, as
they would the real file; a real ``silero_vad.jit`` put in
``WLK_TPU_ASSET_DIR`` is read the same way.

Weights are drawn from a ``torch.Generator`` seeded with ``seed``:
U(-b, b) with b = sqrt(6 / fan_in) for the convolution weights (He
scaling: PyTorch's default, b = 1 / sqrt(fan_in), shrinks the features
through four ReLU convolutions until speech and pauses nearly meet) and
b = 1 / sqrt(fan_in) for every bias and LSTM tensor. A random head does
not tell speech from pauses, so the 0.5 / 0.35 hysteresis would open and
close at random or never, and a stream under ``vac`` could stay inside
its initial silence. ``calibrate=(speech, pause)`` (f32 PCM at 16 kHz;
the CLI uses ``calibration_audio(seed + 1)``) sets the head instead: its
weight points along the difference of the mean features (ReLU of the
LSTM's h) of speech and pause frames, scaled and shifted so that the
least speech-like speech frame maps to logit ``+SPEECH_LOGIT`` and the
most speech-like pause frame to ``logit(0.35) - PAUSE_MARGIN`` (the head
is linear in its weight and bias, and nothing downstream of it feeds
back, so the features do not move). Then every frame past the first ``SETTLE`` of each span is scored
again through the scripted forward and checked against those margins; it
raises ``ValueError`` when the seeded tower does not separate the two.

This is a stand-in that lets VAC open and close on synthetic audio. It
makes no claim about detecting speech: the encoder and LSTM are random, and
the head separates loud voiced audio from faint noise because they reach
different feature regions. Calibrate on audio of other seeds than the audio
the stand-in then scores.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .signals import speech_like

FRAME = 512
CONTEXT = 64
N_FFT = 256
HOP = 128
CHANNELS = ((129, 128, 1), (128, 64, 2), (64, 64, 2), (64, 128, 1))  # (in, out, stride) of encoder.{i}
HIDDEN = 128
SETTLE = 4            # frames after each span's start that the calibration does not hold
SPEECH_LOGIT = 3.0    # the least speech-like calibration speech frame's logit
PAUSE_MARGIN = 3.0    # the most speech-like calibration pause frame sits this far under logit(0.35)
CHECK_MARGIN = 1.0    # every checked frame clears its threshold's logit by at least this much
FILE_NAME = "silero_vad.jit"


def stft_basis() -> torch.Tensor:
    """[258, 1, 256] f32: the real and imaginary rows of the first 129 DFT
    bins of a 256-point transform, under a periodic Hann window."""
    fourier = np.fft.fft(np.eye(N_FFT))
    cut = N_FFT // 2 + 1
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT)
    basis = np.vstack([fourier.real[:cut], fourier.imag[:cut]]) * window[None, :]
    return torch.from_numpy(basis.astype(np.float32))[:, None, :]


class _STFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("forward_basis_buffer", stft_basis())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (TorchScript reads no module-level constants: CONTEXT, HOP, N_FFT // 2 + 1)
        x = F.pad(x, [0, 64], mode="reflect")
        spect = F.conv1d(x.unsqueeze(1), self.forward_basis_buffer, stride=128)
        real, imag = spect[:, :129], spect[:, 129:]
        return torch.sqrt(real * real + imag * imag)


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.reparam_conv = nn.Conv1d(cin, cout, 3, stride=stride, padding=1)
        self.activation = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.reparam_conv(x))


class _Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.rnn = nn.LSTMCell(HIDDEN, HIDDEN)
        self.decoder = nn.Sequential(nn.Dropout(0.1), nn.ReLU(), nn.Conv1d(HIDDEN, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h, c = self.rnn(x.squeeze(-1), (h, c))
        return self.decoder(h.unsqueeze(-1)).squeeze(-1), h, c


class _Tower(nn.Module):
    def __init__(self):
        super().__init__()
        self.stft = _STFT()
        self.encoder = nn.Sequential(*(_Block(i, o, s) for i, o, s in CHANNELS))
        self.decoder = _Decoder()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 576] context + frame → [B, 128] LSTM input."""
        return self.encoder(self.stft(x)).squeeze(-1)


class SileroStandin(nn.Module):
    """Silero v6's 16 kHz call contract: ``forward(x [B, 512] or [512], sr)``
    → ``prob [B, 1]``, state carried in buffers between calls and reset when
    the batch size changes or ``reset_states()`` is called."""

    def __init__(self):
        super().__init__()
        self._model = _Tower()
        self.register_buffer("_h", torch.zeros(1, HIDDEN))
        self.register_buffer("_c", torch.zeros(1, HIDDEN))
        self.register_buffer("_context", torch.zeros(1, CONTEXT))

    @torch.jit.export
    def reset_states(self, batch_size: int = 1) -> None:
        # (TorchScript reads no module-level constants: HIDDEN, CONTEXT)
        self._h = torch.zeros(batch_size, 128, device=self._h.device)
        self._c = torch.zeros(batch_size, 128, device=self._c.device)
        self._context = torch.zeros(batch_size, 64, device=self._context.device)

    def forward(self, x: torch.Tensor, sr: int) -> torch.Tensor:
        if x.dim() == 1:
            x = x.unsqueeze(0)
        if sr != 16000:
            raise ValueError("this stand-in holds only the 16 kHz model")
        if x.shape[-1] != 512:
            raise ValueError("expected 512 samples a frame at 16 kHz")
        if x.shape[0] != self._h.shape[0]:
            self.reset_states(x.shape[0])
        x = torch.cat([self._context, x], dim=1)
        self._context = x[:, -64:]
        prob, h, c = self._model.decoder(self._model.features(x), self._h, self._c)
        self._h = h
        self._c = c
        return prob


def _seed_weights(model: SileroStandin, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".rnn." in name:
                fan_in = HIDDEN
            else:
                conv = model.get_submodule(name.rsplit(".", 1)[0])
                fan_in = conv.in_channels * conv.kernel_size[0]
            bound = (math.sqrt(6.0) if name.endswith("conv.weight") else 1.0) / math.sqrt(fan_in)
            p.copy_((torch.rand(p.shape, generator=g, dtype=torch.float64) * 2 - 1).float() * bound)


def _frames(pcm: np.ndarray) -> np.ndarray:
    n = len(pcm) // FRAME
    return np.asarray(pcm[: n * FRAME], np.float32).reshape(n, FRAME)


def _spans(speech: Sequence[np.ndarray], pause: Sequence[np.ndarray]) -> List[Tuple[np.ndarray, bool]]:
    """Alternating pause / speech spans (a stream opens in silence), each
    a [n, 512] frame array with its label."""
    out = []
    for i in range(max(len(speech), len(pause))):
        if i < len(pause):
            out.append((_frames(pause[i]), False))
        if i < len(speech):
            out.append((_frames(speech[i]), True))
    return out


def _score(model, spans, head: bool) -> List[np.ndarray]:
    """Run the spans back to back through one stream, state carried; per
    span, each frame's head input (``head=False``: ReLU(h) [n, 128]) or its
    probability through the scripted forward (``head=True``: [n])."""
    model.reset_states(1)
    out = []
    with torch.no_grad():
        for frames, _ in spans:
            rows = []
            for f in frames:
                p = model(torch.from_numpy(f), 16000)
                rows.append(p.reshape(()).item() if head else torch.relu(model._h[0]).numpy().copy())
            out.append(np.asarray(rows, np.float64))
    return out


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


def calibrate_head(model: SileroStandin, speech: Sequence[np.ndarray], pause: Sequence[np.ndarray]) -> None:
    """Set the head (``_model.decoder.decoder.2``) so the model separates
    the ``speech`` spans from the ``pause`` spans (see the module
    docstring), then check every frame past ``SETTLE`` of each span through
    the scripted forward; raises ``ValueError`` when the seeded tower does
    not separate the two."""
    spans = _spans(speech, pause)
    feats = _score(model, spans, head=False)
    sp = np.concatenate([f[SETTLE:] for f, (_, is_speech) in zip(feats, spans) if is_speech])
    pa = np.concatenate([f[SETTLE:] for f, (_, is_speech) in zip(feats, spans) if not is_speech])
    direction = sp.mean(0) - pa.mean(0)
    hi, lo = (sp @ direction).min(), (pa @ direction).max()
    if not hi > lo:
        raise ValueError(f"the seeded tower does not separate speech from pauses (speech min {hi:.4g} "
                         f"<= pause max {lo:.4g} along the mean difference)")
    low_target = float(_logit(np.float64(0.35))) - PAUSE_MARGIN
    scale = (SPEECH_LOGIT - low_target) / (hi - lo)
    head = model._model.decoder.decoder[2]
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(scale * direction).float().reshape(1, HIDDEN, 1))
        head.bias.fill_(float(SPEECH_LOGIT - scale * hi))
    logits = [_logit(p) for p in _score(torch.jit.script(model), spans, head=True)]
    speech_min = min(float(lg[SETTLE:].min()) for lg, (_, s) in zip(logits, spans) if s)
    pause_max = max(float(lg[SETTLE:].max()) for lg, (_, s) in zip(logits, spans) if not s)
    if speech_min < CHECK_MARGIN or pause_max > float(_logit(np.float64(0.35))) - CHECK_MARGIN:
        raise ValueError(f"the calibrated head misses its margins: speech logit min {speech_min:.4g}, "
                         f"pause logit max {pause_max:.4g}")
    model.reset_states(1)


def calibration_audio(seed: int, seconds: float = 1.5) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Speech and pause spans made from ``seed`` with numpy: voiced spans
    (``signals.speech_like`` at three fundamentals, and modulated tones
    under white noise at two amplitudes) and pauses (faint white noise at
    three levels, and digital silence)."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    speech = [speech_like(n, seed=int(rng.integers(1 << 30)), f0=f0) for f0 in (110.0, 160.0, 230.0)]
    for amp in (0.15, 0.3):
        f0 = rng.uniform(120, 320)
        tone = amp * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        speech.append((tone + 0.02 * rng.standard_normal(n)).astype(np.float32))
    pause = [(level * rng.standard_normal(n)).astype(np.float32) for level in (3e-4, 1e-3, 2e-3)]
    pause.append(np.zeros(n, np.float32))
    return speech, pause


def write_silero_standin(path, seed: int, calibrate: Optional[Tuple[Iterable[np.ndarray], Iterable[np.ndarray]]] = None
                         ) -> Path:
    """Build the stand-in from ``seed`` (its head calibrated on
    ``calibrate=(speech, pause)`` when given), script it and save it.
    ``path`` is a directory (the file lands at ``path/silero_vad.jit``, the
    name ``find_silero_jit`` looks for in ``WLK_TPU_ASSET_DIR``) or a file
    path ending in ``.jit``. Returns the file's path."""
    path = Path(path)
    if path.suffix != ".jit":
        path = path / FILE_NAME
    path.parent.mkdir(parents=True, exist_ok=True)
    model = SileroStandin()
    _seed_weights(model, seed)
    model.eval()
    if calibrate is not None:
        speech, pause = calibrate
        calibrate_head(model, list(speech), list(pause))
    torch.jit.script(model).save(str(path))
    return path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for silero_vad.jit (or a .jit path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    path = write_silero_standin(args.out, args.seed, calibrate=calibration_audio(args.seed + 1))
    print(path)
    return path


if __name__ == "__main__":
    main()
