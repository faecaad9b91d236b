"""The system under test: the port's streaming engine and batch scheduler,
built from a configuration file and the benchmark's weights, and the
benchmark's records of every tick.

Each session is one ``SimulStreamingOnlineProcessor`` on the shared
``AlignAttEngine`` and ``BatchScheduler``, called as the session pipeline
calls it (``insert_audio_chunk``, then ``process_iter_async``). The
benchmark wraps each session's ``prepare_tick`` and ``finish_tick``
(host calls on the event loop's thread) to record what every tick was
planned to do and what it answered; it changes neither.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class TickRecord:
    sid: int
    t_prep: float           # perf_counter when the tick was planned
    t_done: float = 0.0     # when its result reached the session
    due: Optional[float] = None  # when the last sample it consumed was due (open loop)
    fed: int = 0            # samples fed to the session when it was planned
    advanced: int = 0       # samples fed since the session's previous tick
    mode: str = "legacy"    # "anchor" | "inc" | "legacy"
    pooled: bool = False
    win: int = 0
    prefix: List[int] = field(default_factory=list)
    tail_start: int = 0
    write_start: int = 0
    refresh: List[tuple] = field(default_factory=list)
    new_tokens: List[int] = field(default_factory=list)
    n_keep: int = 0
    reason: int = 0

    @property
    def dec_rows(self) -> List[int]:
        """Positions of the decoder rows the tick decoded before its loop."""
        if self.mode == "anchor":
            return list(range(len(self.prefix)))
        return sorted({p for _, p in self.refresh if p < len(self.prefix)})

    def loop_decodes(self, max_steps: int, eot: int) -> int:
        """Loop decodes the lane needed: one fewer than the steps it ran."""
        if self.reason in (1, 2) and self.n_keep < max_steps:  # eot, gate
            ran = self.n_keep + 1
        elif self.reason in (3, 4):  # rewind, no speech: keeps nothing
            text = [i for i, t in enumerate(self.new_tokens) if t != eot]
            ran = (text[-1] + 1) if text else 1
        else:
            ran = self.n_keep
        return max(ran - 1, 0)


class Recorder:
    def __init__(self):
        self.records: List[TickRecord] = []
        self._open: Dict[int, TickRecord] = {}
        self._last_fed: Dict[int, int] = {}

    def attach(self, proc, sid: int, fed: Callable[[], int], due: Callable[[int], Optional[float]] = None):
        sess = proc.model
        prep0, fin0 = sess.prepare_tick, sess.finish_tick

        def prepare_tick(is_last=False):
            ti = prep0(is_last)
            if ti is not None:
                n = fed()
                rec = TickRecord(sid=sid, t_prep=time.perf_counter(), fed=n,
                                 advanced=n - self._last_fed.get(sid, 0),
                                 due=due(n) if due else None)
                self._last_fed[sid] = n
                rec.mode = ti.enc_mode or "legacy"
                rec.pooled = ti.xkv_slot is not None
                rec.win = len(ti.audio) if ti.audio is not None else 0
                rec.prefix = list(ti.prefix_ids)
                rec.tail_start, rec.write_start = int(ti.tail_start), int(ti.write_start)
                if ti.skv_refresh_tokens is not None:
                    rec.refresh = [(int(a), int(b)) for a, b in zip(ti.skv_refresh_tokens, ti.skv_refresh_pos)]
                self._open[id(ti)] = rec
            return ti

        def finish_tick(ti, out):
            rec = self._open.pop(id(ti), None)
            if rec is not None:
                rec.t_done = time.perf_counter()
                rec.new_tokens = [int(t) for t in out.new_tokens]
                rec.n_keep, rec.reason = int(out.n_keep), int(out.reason)
                self.records.append(rec)
            return fin0(ti, out)

        sess.prepare_tick = prepare_tick
        sess.finish_tick = finish_tick


def port_dims(cfg: dict):
    from whisperlivekit_tpu_torch.models.whisper.dims import ModelDimensions

    return ModelDimensions(
        n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"], n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"], n_vocab=cfg["vocab_size"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"], n_text_layer=cfg["decoder_layers"],
    )


class System:
    """The port's engine and scheduler for one configuration."""

    def __init__(self, cfg: dict, state_dict, device, control: Optional[str] = None):
        import torch

        from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler
        from whisperlivekit_tpu_torch.models.whisper import model as wm
        from whisperlivekit_tpu_torch.models.whisper.load import convert_openai_state_dict
        from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer
        from whisperlivekit_tpu_torch.streaming.alignatt import AlignAttConfig, AlignAttEngine

        serving = cfg["serving"]
        dims = port_dims(cfg)
        dtype = getattr(torch, serving["dtype"])
        model = convert_openai_state_dict(state_dict, dims, dtype=dtype, device=device)
        pools = serving.get("xkv_cache_dtype", "bf16")
        if control == "f8":
            # the program's own lower-precision path: f8 decoder linears and
            # f8 cross-KV pools
            model = wm.quantize_decoder_f8(model)
            pools = "f8"
        self.tokenizer = get_tokenizer(True, num_languages=dims.num_languages,
                                       language=serving["language"], task="transcribe")
        acfg = AlignAttConfig(
            language=serving["language"], frame_threshold=serving["frame_threshold"],
            max_steps=serving["max_steps"], xkv_cache_dtype=pools,
            xkv_budget_bytes=int(serving["xkv_budget_gib"] * (1 << 30)),
            xkv_cache=serving.get("xkv_cache", "auto"),
        )
        self.engine = AlignAttEngine(model, dims, self.tokenizer, acfg, model_name=cfg["alignment_heads"])
        t = time.perf_counter()
        self.scheduler = BatchScheduler(self.engine, max_lanes=int(serving.get("max_lanes", 96)))
        self.warm_s = time.perf_counter() - t
        self.lanes = self.scheduler.max_lanes
        self.dims = dims
        self.cfg = cfg
        self.recorder = Recorder()

    def new_session(self):
        from whisperlivekit_tpu_torch.streaming.simul_processor import SimulStreamingOnlineProcessor

        return SimulStreamingOnlineProcessor(self.engine, scheduler=self.scheduler)

    def phase_stats(self) -> dict:
        from whisperlivekit_tpu_torch.streaming import alignatt

        return {k: tuple(v) for k, v in alignatt.TICK_PHASE_STATS.items()}

    def anchor_reasons(self) -> dict:
        from whisperlivekit_tpu_torch.streaming import alignatt

        return dict(alignatt.ANCHOR_REASONS)

    def close(self) -> None:
        """Drop every reference to the program's state."""
        self.scheduler = None
        self.engine = None
