"""Plain float32 reference of Whisper under the AlignAtt streaming plan.

This file imports only torch and numpy. It knows nothing of the program
under test: it is handed the weights (an OpenAI-layout state dict that the
benchmark drew), the audio the benchmark fed, the vocabulary file the
benchmark wrote, and, for each tick of a session, the plan the program's
host policy chose (window, tail and refresh rows, prefix tokens) and the
tokens the program served. From those it works out again everything the
program derived on the device (log-mel, encoder rows, cross-attention
keys and values, decoder self-attention rows) and scores each served token
by how far its logit lies below the reference's best.

The streaming plan is an approximation of a full re-encode by design: an
"inc" tick re-encodes only a window tail, with tail-local attention, over
encoder rows cached from earlier ticks, and the decoder refreshes only a
few self-attention rows over cached ones. The reference follows that plan
step by step, so it replays a session from its first tick.

Math (OpenAI Whisper): log-mel of 16 kHz PCM (periodic Hann 400, hop 160,
reflect padding, slaney mel filters, log10 floored 8 below the item's max,
(x + 4) / 4); encoder = two GELU convolutions, sinusoidal positions,
pre-LN blocks with exact GELU; decoder = token and learned position
embeddings, pre-LN blocks with causal self-attention and cross-attention,
tied unembedding. Matmuls run in float32 with TF32 off.
"""

from __future__ import annotations

import base64
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SR
SAMPLES_PER_FRAME = 320  # one encoder frame is 20 ms
DRY_MAX_MATCH = 50       # suffix matches counted up to 49 tokens back

# reasons a lane stops (the program's packed output codes)
STOP_EOT, STOP_GATE, STOP_REWIND, STOP_NOSPEECH, STOP_CAP, STOP_CTX = 1, 2, 3, 4, 5, 6


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------


def mel_filters(n_mels: int, sr: int = SR, n_fft: int = N_FFT) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) with htk=False, norm="slaney"."""
    f_sp = 200.0 / 3
    min_log_hz, min_log_mel, logstep = 1000.0, 1000.0 / f_sp, math.log(6.4) / 27.0

    def hz_to_mel(f: float) -> float:
        return min_log_mel + math.log(f / min_log_hz) / logstep if f >= min_log_hz else f / f_sp

    def mel_to_hz(m: np.ndarray) -> np.ndarray:
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    ramps = pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """[n] float audio -> [n_mels, n // HOP] log-mel (the last STFT frame
    dropped, as Whisper does)."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=audio.device)
    spec = torch.stft(audio.double(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = (spec.abs() ** 2)[:, :-1].float()
    mel = filters @ power
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pcm16(audio: np.ndarray) -> np.ndarray:
    """The 16-bit PCM a window is held in: clip, scale, truncate."""
    return (np.clip(audio, -1.0, 1.0 - 1 / 32768) * 32768.0).astype(np.int16)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class Dims:
    n_mels: int
    n_audio_ctx: int
    d: int
    n_head: int
    n_enc: int
    n_dec: int
    n_vocab: int
    n_text_ctx: int


class Weights:
    """float32 views of an OpenAI-layout state dict, widened a tensor at a
    time when first used and kept."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd, self.device, self._f32 = sd, device, {}

    def __call__(self, name: str) -> Optional[torch.Tensor]:
        t = self._f32.get(name)
        if t is None:
            src = self.sd.get(name)
            if src is None:
                return None
            t = self._f32[name] = src.to(self.device, torch.float32)
        return t


def _lin(x, w, prefix: str, bias: bool = True):
    y = x @ w(prefix + ".weight").t()
    b = w(prefix + ".bias") if bias else None
    return y + b if b is not None else y


def _ln(x, w, prefix: str):
    return F.layer_norm(x, (x.shape[-1],), w(prefix + ".weight"), w(prefix + ".bias"), 1e-5)


def _heads(x, n_head):
    return x.reshape(x.shape[0], n_head, -1).transpose(0, 1)  # [H, S, Dh]


def _attention(q, k, v, n_head, mask=None):
    """q [S, D], k/v [T, D] -> [S, D]; mask [S, T] bool (True = visible)."""
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    s = qh @ kh.transpose(1, 2) * (qh.shape[-1] ** -0.5)
    if mask is not None:
        s = s.masked_fill(~mask[None], float("-inf"))
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(0, 1).reshape(q.shape[0], -1)


class Whisper:
    def __init__(self, sd: Dict[str, torch.Tensor], dims: Dims, device):
        no_tf32()
        self.w = Weights(sd, device)
        self.dims = dims
        self.device = device
        self.filters = torch.from_numpy(mel_filters(dims.n_mels)).to(device)
        self.pos = sinusoids(dims.n_audio_ctx, dims.d).to(device)

    def encode(self, mel: torch.Tensor, pos_start: int = 0) -> torch.Tensor:
        """mel [n_mels, 2F] -> [F, D]; frame f carries position pos_start + f
        (clamped to the last position)."""
        w, dims = self.w, self.dims
        x = F.gelu(F.conv1d(mel[None], w("encoder.conv1.weight"), w("encoder.conv1.bias"), padding=1))
        x = F.gelu(F.conv1d(x, w("encoder.conv2.weight"), w("encoder.conv2.bias"), stride=2, padding=1))
        x = x[0].t()
        idx = torch.clamp(torch.arange(x.shape[0], device=x.device) + pos_start, max=dims.n_audio_ctx - 1)
        x = x + self.pos[idx]
        for i in range(dims.n_enc):
            p = f"encoder.blocks.{i}"
            h = _ln(x, w, p + ".attn_ln")
            q, k, v = _lin(h, w, p + ".attn.query"), _lin(h, w, p + ".attn.key", False), _lin(h, w, p + ".attn.value")
            x = x + _lin(_attention(q, k, v, dims.n_head), w, p + ".attn.out")
            h = _ln(x, w, p + ".mlp_ln")
            x = x + _lin(F.gelu(_lin(h, w, p + ".mlp.0")), w, p + ".mlp.2")
        return _ln(x, w, "encoder.ln_post")

    def cross_kv(self, rows: torch.Tensor):
        """Every decoder layer's cross-attention keys and values of ``rows``."""
        w = self.w
        ks, vs = [], []
        for i in range(self.dims.n_dec):
            p = f"decoder.blocks.{i}.cross_attn"
            ks.append(_lin(rows, w, p + ".key", False))
            vs.append(_lin(rows, w, p + ".value"))
        return ks, vs


class DecoderState:
    """Self-attention keys and values by position, one [n_text_ctx, D] pair
    per layer, as the program's cache holds them: a row stays as it was
    written until a later call writes its position again."""

    def __init__(self, model: Whisper):
        d = model.dims
        z = lambda: torch.zeros((d.n_text_ctx, d.d), device=model.device)  # noqa: E731
        self.k = [z() for _ in range(d.n_dec)]
        self.v = [z() for _ in range(d.n_dec)]


def decode_rows(model: Whisper, st: DecoderState, xkv, tokens: Sequence[int], positions: Sequence[int]):
    """Decode rows of ``tokens`` at ``positions`` in one pass: each layer
    writes every row's key and value first, then each row attends to the
    cache at positions up to its own. Returns logits [rows, V]."""
    w, dims = model.w, model.dims
    dev = model.device
    tok = torch.as_tensor(list(tokens), device=dev, dtype=torch.long)
    pos = torch.as_tensor(list(positions), device=dev, dtype=torch.long)
    x = w("decoder.token_embedding.weight")[tok] + w("decoder.positional_embedding")[pos]
    top = int(pos.max()) + 1
    mask = torch.arange(top, device=dev)[None, :] <= pos[:, None]
    xk, xv = xkv
    for i in range(dims.n_dec):
        p = f"decoder.blocks.{i}"
        h = _ln(x, w, p + ".attn_ln")
        q = _lin(h, w, p + ".attn.query")
        st.k[i][pos] = _lin(h, w, p + ".attn.key", False)
        st.v[i][pos] = _lin(h, w, p + ".attn.value")
        x = x + _lin(_attention(q, st.k[i][:top], st.v[i][:top], dims.n_head, mask), w, p + ".attn.out")
        h = _ln(x, w, p + ".cross_attn_ln")
        qx = _lin(h, w, p + ".cross_attn.query")
        x = x + _lin(_attention(qx, xk[i], xv[i], dims.n_head), w, p + ".cross_attn.out")
        h = _ln(x, w, p + ".mlp_ln")
        x = x + _lin(F.gelu(_lin(h, w, p + ".mlp.0")), w, p + ".mlp.2")
    x = _ln(x, w, "decoder.ln")
    return x @ w("decoder.token_embedding.weight").t()


# ---------------------------------------------------------------------------
# Logit filters of the AlignAtt step (suppression, first-step blanks, DRY)
# ---------------------------------------------------------------------------


def space_token(vocab_file: Path) -> int:
    """Rank of the single-space token in a tiktoken rank file."""
    for line in Path(vocab_file).read_text().splitlines():
        tok, rank = line.split()
        if base64.b64decode(tok) == b" ":
            return int(rank)
    raise ValueError(f"{vocab_file} has no single-space token")


def dry_penalty(seq: List[int], eot: int) -> Dict[int, float]:
    """DRY v0 over a token sequence: for each earlier occurrence i of the
    last token whose follower is text, count how many tokens before i match
    the tokens before the end (up to 49, text only); a follower whose
    longest match is n >= 2 loses 2**(n - 2). Applies once the sequence has
    5 tokens and its last is text."""
    end = len(seq) - 1
    if end + 1 < 5 or seq[end] >= eot:
        return {}
    last = seq[end]
    best: Dict[int, int] = {}
    for i in range(end):
        nxt = seq[i + 1]
        if seq[i] != last or nxt >= eot:
            continue
        n = 1
        for l in range(1, DRY_MAX_MATCH):
            j, k = i - l, end - l
            if j < 0 or k <= i or seq[j] != seq[k] or seq[j] >= eot:
                break
            n += 1
        best[nxt] = max(best.get(nxt, 0), n)
    return {t: 2.0 ** (n - 2) for t, n in best.items() if n >= 2}


def filtered(logits: torch.Tensor, seq: List[int], first: bool, eot: int, space: int) -> torch.Tensor:
    """The step's logits as its argmax sees them: every id past end-of-text
    (Whisper's special and timestamp tokens) suppressed, blanks (space and
    end-of-text) suppressed on a tick's first step, the DRY penalty."""
    lg = logits.clone()
    lg[eot + 1:] = float("-inf")
    if first:
        lg[space] = float("-inf")
        lg[eot] = float("-inf")
    for t, pen in dry_penalty(seq, eot).items():
        lg[t] -= pen
    return lg


# ---------------------------------------------------------------------------
# Session replay
# ---------------------------------------------------------------------------


@dataclass
class Tick:
    """One tick of a session as the program planned and answered it."""

    mode: str                 # "anchor" | "inc"
    fed: int                  # samples fed to the session when it planned the tick
    win: int                  # samples in the window (its last sample is fed - 1)
    prefix: List[int]
    tail_start: int = 0
    write_start: int = 0
    refresh: List[tuple] = field(default_factory=list)  # (token, position) rows
    new_tokens: List[int] = field(default_factory=list)
    n_keep: int = 0
    reason: int = 0
    scored: bool = True


def served_count(t: Tick, max_steps: int) -> int:
    """Tokens the tick's argmax produced while the lane ran: the kept ones,
    and the one it dropped where it stopped on end-of-text or the gate.
    A rewind or no-speech stop keeps nothing and serves nothing."""
    if t.reason in (STOP_EOT, STOP_GATE) and t.n_keep < max_steps:
        return t.n_keep + 1
    if t.reason in (STOP_REWIND, STOP_NOSPEECH):
        return 0
    return t.n_keep


@dataclass
class Replay:
    gaps: List[float]
    ticks: int
    scored_ticks: int


def replay_session(model: Whisper, audio: np.ndarray, ticks: List[Tick], tail_frames: int,
                   max_steps: int, eot: int, space: int, write_block: int = 128) -> Replay:
    """Replay one session's ticks in order. ``audio`` is the float32 stream
    the session was fed. Returns the logit gap of every served token of the
    scored ticks: the reference's best filtered logit minus that of the
    token the program served."""
    dims, dev = model.dims, model.device
    T = dims.n_audio_ctx
    rows = None
    st = None
    gaps: List[float] = []
    n_scored = 0
    for t in ticks:
        window = np.zeros(N_SAMPLES, np.int16)
        window[: t.win] = pcm16(audio[t.fed - t.win: t.fed])
        if t.mode == "anchor":
            x = torch.from_numpy(window.astype(np.float32) / 32768.0).to(dev)
            rows = model.encode(log_mel(x, model.filters)[:, : 2 * T])
            st = DecoderState(model)
            xkv = model.cross_kv(rows)
            lg = decode_rows(model, st, xkv, t.prefix, range(len(t.prefix)))[-1]
        elif t.mode == "inc":
            if rows is None:
                raise ValueError("an inc tick before the session's first anchor")
            ts = t.tail_start + (t.tail_start & 1)
            n_tail = (tail_frames + 1) * SAMPLES_PER_FRAME
            seg = np.zeros(n_tail, np.int16)
            piece = window[ts * SAMPLES_PER_FRAME: ts * SAMPLES_PER_FRAME + n_tail]
            seg[: len(piece)] = piece
            x = torch.from_numpy(seg.astype(np.float32) / 32768.0).to(dev)
            enc = model.encode(log_mel(x, model.filters)[:, : 2 * tail_frames], pos_start=ts)
            win_frames = t.win // SAMPLES_PER_FRAME
            ws = min(t.write_start, win_frames - write_block) if win_frames >= write_block else t.write_start
            ws = max(ws, ts)
            if ws < win_frames:
                src = torch.clamp(torch.arange(ws, win_frames, device=dev) - ts, 0, tail_frames - 1)
                rows[ws:win_frames] = enc[src]
            xkv = model.cross_kv(rows)
            plen = len(t.prefix)
            real = {}
            for tok, pos in t.refresh:
                if pos < plen:
                    real[pos] = tok
            order = sorted(real)
            out = decode_rows(model, st, xkv, [real[p] for p in order], order)
            lg = out[order.index(plen - 1)]
        else:
            raise ValueError(f"tick mode {t.mode!r} has no reference")
        seq = list(t.prefix)
        plen = len(seq)
        n = served_count(t, max_steps)
        for k in range(n):
            f = filtered(lg, seq, k == 0, eot, space)
            if t.scored:
                gaps.append(float(f.max() - f[t.new_tokens[k]]))
            seq.append(t.new_tokens[k])
            if k < t.n_keep and k + 1 < max_steps:
                lg = decode_rows(model, st, xkv, [t.new_tokens[k]], [min(plen + k, dims.n_text_ctx - 1)])[0]
        n_scored += int(t.scored)
    return Replay(gaps=gaps, ticks=len(ticks), scored_ticks=n_scored)
