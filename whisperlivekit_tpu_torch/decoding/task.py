"""Batch decoding machinery: greedy + logit filters + timestamp rules (port
of whisperlivekit_tpu/decoding/task.py).

The JAX module runs the whole sampling loop as one jitted
``lax.while_loop``. Here ``greedy_loop`` is a host loop of ``wm.decode``
steps on the model's device: the prefill over the right-padded prompt, then
one step per sampled token, with the filter state (``_apply_filters``'s
last / penultimate token, last timestamp, finished flags) kept as device
tensors. The loop reads ``finished.all()`` once a step to stop early. The
prompt layout, the filters' order and masks, the ranking and the results
are the JAX module's.

Sampling at ``temperature > 0`` draws from an explicit ``torch.Generator``
on the decoding device seeded as JAX seeds its key
(``int(temperature * 1e6) + 42``): deterministic per seed, but not JAX's
draws.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.whisper import model as wm
from ..models.whisper.dims import ModelDimensions
from ..models.whisper.tokenizer import Tokenizer, get_tokenizer
from .options import DecodingOptions, DecodingResult, compression_ratio


# ---------------------------------------------------------------------------
# Static token plumbing (host side)
# ---------------------------------------------------------------------------


def get_suppress_tokens(tokenizer: Tokenizer, options: DecodingOptions) -> Tuple[int, ...]:
    """Resolve options.suppress_tokens to the full static suppression set
    (reference whisper/decoding.py `_get_suppress_tokens`)."""
    suppress = options.suppress_tokens
    if isinstance(suppress, str):
        suppress = [int(t) for t in suppress.split(",")] if suppress else []
    else:
        suppress = list(suppress) if suppress else []

    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)

    suppress.extend([tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
                     tokenizer.sot_prev, tokenizer.sot_lm])
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    return tuple(sorted(set(suppress)))


def build_initial_tokens(
    tokenizer: Tokenizer, options: DecodingOptions, n_ctx: int
) -> List[int]:
    """sot sequence + optional prefix/prompt conditioning (reference
    whisper/decoding.py `_get_initial_tokens`)."""
    tokens = list(tokenizer.sot_sequence)
    if options.without_timestamps:
        tokens.append(tokenizer.no_timestamps)
    sample_len = options.sample_len or n_ctx // 2

    if options.prefix is not None:
        prefix = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str)
            else list(options.prefix)
        )
        max_prefix_len = n_ctx // 2 - sample_len
        if max_prefix_len > 0:
            prefix = prefix[-max_prefix_len:]
        tokens = tokens + prefix

    if options.prompt is not None:
        prompt = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str)
            else list(options.prompt)
        )
        tokens = [tokenizer.sot_prev] + prompt[-(n_ctx // 2 - 1):] + tokens
    return tokens


def truncate_initial_tokens(initial: List[int], width: int, sot_prev: int) -> List[int]:
    """Fit the initial sequence into the static prefill width, always
    retaining <|startofprev|> at position 0 when present — raw prompt tokens
    without it are out-of-distribution for the model."""
    if len(initial) <= width:
        return initial
    if initial[0] == sot_prev:
        return [sot_prev] + initial[-(width - 1) :]
    return initial[-width:]


# ---------------------------------------------------------------------------
# Greedy / temperature sampling loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RuleConsts:
    """Static scalars of the sampling rules."""

    eot: int
    ts_begin: int
    no_ts: int
    space_tok: int          # first token of " " — blank suppression
    prompt_width: int       # static right-padded prompt width
    n_ctx: int
    use_timestamps: bool
    suppress_blank: bool


def _apply_filters(
    logits: torch.Tensor,  # [B, V] f32
    k: int,  # step index (0 = first sampled token)
    last_tok: torch.Tensor,  # [B]
    penult_tok: torch.Tensor,  # [B]
    last_ts: torch.Tensor,  # [B] last sampled timestamp token (ts_begin if none)
    has_ts: torch.Tensor,  # [B] bool
    suppress_mask: torch.Tensor,  # [V] additive 0/-inf
    max_initial_ts_index: int,  # n_vocab when unlimited
    c: RuleConsts,
) -> torch.Tensor:
    V = logits.shape[-1]
    vocab_idx = torch.arange(V, device=logits.device)[None, :]
    neg_inf = float("-inf")

    if c.suppress_blank and k == 0:
        blank = (vocab_idx == c.space_tok) | (vocab_idx == c.eot)
        logits = logits.masked_fill(blank, neg_inf)

    logits = logits + suppress_mask[None, :]

    if not c.use_timestamps:
        return logits

    is_ts = vocab_idx >= c.ts_begin
    is_text = vocab_idx < c.eot

    # no_timestamps token never allowed under timestamp rules.
    logits = logits.masked_fill(vocab_idx == c.no_ts, neg_inf)

    last_was_ts = (last_tok >= c.ts_begin) & (k > 0)
    penult_was_ts = (penult_tok >= c.ts_begin) | (k < 2)

    # Timestamp pairing: <ts><ts> → text next; <text><ts> → must pair another ts.
    mask_ts_pair = (last_was_ts & penult_was_ts)[:, None] & is_ts
    mask_text_pair = (last_was_ts & ~penult_was_ts)[:, None] & is_text
    logits = logits.masked_fill(mask_ts_pair | mask_text_pair, neg_inf)

    # Non-decreasing timestamps.
    ts_floor = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    mask_floor = has_ts[:, None] & is_ts & (vocab_idx < ts_floor[:, None])
    logits = logits.masked_fill(mask_floor, neg_inf)

    # First sampled token must be a timestamp, capped by max_initial_timestamp.
    if k == 0:
        init_mask = (~is_ts) | (vocab_idx > c.ts_begin + max_initial_ts_index)
        logits = logits.masked_fill(init_mask, neg_inf)

    # If total timestamp probability beats every text token, force a timestamp.
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts, neg_inf), dim=-1)  # [B]
    max_text = logprobs.masked_fill(is_ts, neg_inf).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None] & ~is_ts
    return logits.masked_fill(force_ts, neg_inf)


def _sample(logits: torch.Tensor, temperature: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Argmax at temperature 0 (the first maximum, as ``jnp.argmax``), else
    one categorical draw per row from ``gen`` (the Gumbel-max form of
    ``jax.random.categorical``)."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (logits / max(temperature, 1e-6) + gumbel).argmax(dim=-1)


def greedy_loop(
    model: wm.Whisper,
    xkv: wm.CrossKV,
    cache: wm.KVCache,
    prompt: torch.Tensor,  # [B, prompt_width] right-padded with eot
    sample_begin: int,  # true prompt length
    sot_index: int,  # sot position for no_speech prob
    sample_len: int,  # max new tokens
    suppress_mask: torch.Tensor,  # [V]
    max_initial_ts_index: int,
    temperature: float,  # 0 = argmax
    gen: Optional[torch.Generator],
    dims: ModelDimensions,
    consts: RuleConsts,
):
    """Prefill + filtered greedy/temperature sampling, one ``wm.decode``
    step per token on the prompt's device.

    Returns (tokens [B, n_ctx], lengths [B], sum_logprobs [B],
    no_speech_prob [B], cache), on that device.
    """
    c = consts
    B = prompt.shape[0]
    dev = prompt.device

    prefill_logits, _, cache = wm.decode(
        model, prompt, torch.zeros((B,), dtype=torch.long, device=dev), xkv, cache, dims
    )
    no_speech_prob = torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, c.no_ts - 1]
    # ^ no_speech token id == no_ts - 1 in the whisper vocab layout.
    logits = prefill_logits[:, sample_begin - 1]

    tokens = torch.full((B, c.n_ctx), c.eot, dtype=torch.long, device=dev)
    tokens[:, : prompt.shape[1]] = prompt
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros((B,), dtype=torch.float32, device=dev)
    last_tok = torch.full((B,), -1, dtype=torch.long, device=dev)
    penult_tok = torch.full((B,), -1, dtype=torch.long, device=dev)
    last_ts = torch.full((B,), c.ts_begin, dtype=torch.long, device=dev)
    has_ts = torch.zeros((B,), dtype=torch.bool, device=dev)

    k = 0
    while k < sample_len and sample_begin + k < c.n_ctx:
        flogits = _apply_filters(
            logits, k, last_tok, penult_tok, last_ts, has_ts, suppress_mask,
            max_initial_ts_index, c,
        )
        tok = _sample(flogits, temperature, gen)
        logprobs = torch.log_softmax(flogits, dim=-1)
        tok_logprob = logprobs.gather(1, tok[:, None])[:, 0]
        active = ~finished
        sum_logprobs = sum_logprobs + torch.where(active, tok_logprob, 0.0)
        tok = torch.where(active, tok, c.eot)
        finished = finished | (tok == c.eot)

        pos = sample_begin + k
        tokens[:, pos] = tok
        is_ts_tok = (tok >= c.ts_begin) & active
        last_ts = torch.where(is_ts_tok, tok, last_ts)
        has_ts = has_ts | is_ts_tok
        penult_tok, last_tok = last_tok, tok
        k += 1
        # the JAX loop's condition, read before the step it would guard
        # (the one sync a step); the step's logits would go unread
        if k >= sample_len or sample_begin + k >= c.n_ctx or bool(finished.all()):
            break
        step_logits, _, cache = wm.decode(
            model, tok[:, None], torch.full((B,), pos, dtype=torch.long, device=dev), xkv, cache, dims
        )
        logits = step_logits[:, 0]

    lengths = torch.full((B,), k, dtype=torch.long, device=dev)  # sampled count incl. eot
    return tokens, lengths, sum_logprobs, no_speech_prob, cache


# ---------------------------------------------------------------------------
# Host-side decoding task
# ---------------------------------------------------------------------------


class WhisperDecoder:
    """Holds the model; the DecodingTask equivalent. One decoder serves
    concurrent callers (each LocalAgreement session transcribes from its own
    worker thread): a call keeps its state in locals, and the tokenizer
    table is filled under a lock."""

    def __init__(self, model: wm.Whisper, dims: ModelDimensions, tokenizer_factory=None):
        self.model = model
        self.dims = dims
        # static prefill width: holds the maximal initial sequence —
        # sot_prev + (n_text_ctx//2 - 1) prompt tokens + sot sequence (≤4)
        # (reference whisper/decoding.py _get_initial_tokens bounds)
        self.prompt_width = min(dims.n_text_ctx // 2 + 8, dims.n_text_ctx - 8)
        self._tokenizers: dict = {}
        self._tokenizer_factory = tokenizer_factory
        self._tokenizers_lock = threading.Lock()

    def tokenizer_for(self, language: Optional[str], task: str) -> Tokenizer:
        key = (language, task)
        with self._tokenizers_lock:
            if key not in self._tokenizers:
                if self._tokenizer_factory is not None:
                    self._tokenizers[key] = self._tokenizer_factory(language, task)
                else:
                    self._tokenizers[key] = get_tokenizer(
                        self.dims.multilingual,
                        num_languages=self.dims.num_languages,
                        language=language,
                        task=task,
                    )
            return self._tokenizers[key]

    def encode(self, mel) -> torch.Tensor:
        """mel [B, n_mels, 3000] (a tensor on any device, or numpy) -> the
        encoder output on the model's device (K1 on the card)."""
        mel = torch.as_tensor(mel, device=self.model.device)
        if mel.ndim == 2:
            mel = mel[None]
        return wm.encode(self.model, mel, self.dims)

    # ---- language id -------------------------------------------------------

    def detect_language(self, enc: torch.Tensor, tokenizer: Tokenizer):
        """Single forward from [sot]; returns (codes, prob dicts) per lane."""
        B = enc.shape[0]
        dev = enc.device
        xkv = wm.cross_kv(self.model, enc, self.dims)
        cache = wm.init_cache(self.dims, B, dtype=self.model.dtype, device=dev)
        tokens = torch.full((B, 1), tokenizer.sot, dtype=torch.long, device=dev)
        logits, _, _ = wm.decode(
            self.model, tokens, torch.zeros((B,), dtype=torch.long, device=dev), xkv, cache, self.dims
        )
        logits = logits[:, 0].float().cpu()
        lang_tokens = list(tokenizer.all_language_tokens)
        mask = torch.full((logits.shape[-1],), float("-inf"))
        mask[lang_tokens] = 0.0
        probs = torch.softmax(logits + mask, dim=-1).numpy()
        codes = []
        prob_maps = []
        for b in range(B):
            best = int(probs[b].argmax())
            codes.append(tokenizer._token_to_code(best))
            prob_maps.append(
                {code: float(probs[b, t]) for code, t in zip(tokenizer.all_language_codes, lang_tokens)}
            )
        return codes, prob_maps

    # ---- main entry ----------------------------------------------------------

    def decode(
        self,
        mel,  # [B, n_mels, 3000] or [n_mels, 3000]
        options: DecodingOptions = DecodingOptions(),
        enc: Optional[torch.Tensor] = None,
    ) -> List[DecodingResult]:
        if enc is None:
            enc = self.encode(mel)
        B = enc.shape[0]
        dev = enc.device

        language = options.language
        lang_probs: Optional[list] = None
        if self.dims.multilingual and language is None:
            det_tok = self.tokenizer_for("en", options.task)
            codes, lang_probs = self.detect_language(enc, det_tok)
            language = codes[0]  # windows share a language per call
        elif not self.dims.multilingual:
            language = "en"

        tokenizer = self.tokenizer_for(language, options.task)

        if options.beam_size is not None:
            from .beam import beam_decode

            return beam_decode(self, enc, options, tokenizer, language, lang_probs)

        n_group = options.best_of if (options.best_of and options.temperature > 0) else 1
        initial = build_initial_tokens(tokenizer, options, self.dims.n_text_ctx)
        sample_len = options.sample_len or self.dims.n_text_ctx // 2

        initial = truncate_initial_tokens(initial, self.prompt_width, tokenizer.sot_prev)
        sample_begin = len(initial)
        sot_index = initial.index(tokenizer.sot)
        sample_len = min(sample_len, self.dims.n_text_ctx - sample_begin - 1)

        prompt = np.full((B * n_group, self.prompt_width), tokenizer.eot, np.int64)
        prompt[:, :sample_begin] = initial

        suppress_mask = torch.zeros(self.dims.n_vocab, dtype=torch.float32)
        suppress_mask[list(get_suppress_tokens(tokenizer, options))] = float("-inf")

        if options.max_initial_timestamp is None:
            max_init_idx = self.dims.n_vocab
        else:
            max_init_idx = int(options.max_initial_timestamp / 0.02)

        consts = RuleConsts(
            eot=tokenizer.eot,
            ts_begin=tokenizer.timestamp_begin,
            no_ts=tokenizer.no_timestamps,
            space_tok=tokenizer.encode(" ")[0],
            prompt_width=self.prompt_width,
            n_ctx=self.dims.n_text_ctx,
            use_timestamps=not options.without_timestamps,
            suppress_blank=options.suppress_blank,
        )

        enc_rep = enc.repeat_interleave(n_group, dim=0) if n_group > 1 else enc
        xkv = wm.cross_kv(self.model, enc_rep, self.dims)
        cache = wm.init_cache(self.dims, B * n_group, dtype=self.model.dtype, device=dev)
        gen = None
        if options.temperature > 0:
            gen = torch.Generator(device=dev).manual_seed(int(options.temperature * 1e6) + 42)

        tokens, lengths, sum_logprobs, no_speech_prob, _ = greedy_loop(
            self.model,
            xkv,
            cache,
            torch.from_numpy(prompt).to(dev),
            sample_begin,
            sot_index,
            sample_len,
            suppress_mask.to(dev),
            max_init_idx,
            float(options.temperature),
            gen,
            self.dims,
            consts,
        )
        tokens = tokens.cpu().numpy()
        sum_logprobs = sum_logprobs.cpu().numpy().astype(np.float64)
        no_speech_prob = no_speech_prob.cpu().numpy()

        results = []
        for b in range(B):
            # Rank the n_group samples by length-penalized avg logprob
            # (MaximumLikelihoodRanker, whisper/decoding.py:272-297).
            best_score, best = -np.inf, 0
            cands = []
            for g in range(n_group):
                lane = b * n_group + g
                seq = tokens[lane, sample_begin:]
                eots = np.where(seq == tokenizer.eot)[0]
                seq = seq[: eots[0]] if len(eots) else seq
                n = len(seq) + 1
                if options.length_penalty is None:
                    penalty = n
                else:
                    penalty = ((5 + n) / 6) ** options.length_penalty
                score = sum_logprobs[lane] / max(penalty, 1e-9)
                cands.append((list(int(t) for t in seq), sum_logprobs[lane], n))
                if score > best_score:
                    best_score, best = score, g
            seq, slp, n = cands[best]
            text = tokenizer.decode(seq).strip()
            results.append(
                DecodingResult(
                    audio_features=None,
                    language=language,
                    language_probs=lang_probs[b] if lang_probs else None,
                    tokens=seq,
                    text=text,
                    avg_logprob=float(slp / n),
                    no_speech_prob=float(no_speech_prob[b * n_group]),
                    temperature=options.temperature,
                    compression_ratio=compression_ratio(text),
                )
            )
        return results
