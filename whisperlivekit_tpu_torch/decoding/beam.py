"""Beam-search decoding (reference whisper/decoding.py BeamSearchDecoder:299-377;
port of whisperlivekit_tpu/decoding/beam.py).

Host-driven control with device steps: logit filtering runs in the same
rule code as the greedy path (``task._apply_filters``, on the device); the
per-step top-k bookkeeping and the finished-sequence dictionaries live on
the host in numpy, as in the JAX module (the same ``np.argpartition`` and
the same stable sort, so ties break in the same order), and beam
reordering is a lane gather on the KV cache.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.whisper import model as wm
from .options import DecodingOptions, DecodingResult, compression_ratio


def _reorder_cache(cache: wm.KVCache, src: torch.Tensor) -> wm.KVCache:
    return wm.KVCache(k=cache.k.index_select(1, src), v=cache.v.index_select(1, src))


def beam_decode(
    decoder,
    enc: torch.Tensor,
    options: DecodingOptions,
    tokenizer,
    language: str,
    lang_probs: Optional[list],
) -> List[DecodingResult]:
    from .task import RuleConsts, _apply_filters, build_initial_tokens, get_suppress_tokens

    dims = decoder.dims
    model = decoder.model
    dev = enc.device
    n_audio = enc.shape[0]
    beam = options.beam_size
    patience = options.patience or 1.0
    max_candidates = round(beam * patience)
    lanes = n_audio * beam

    initial = build_initial_tokens(tokenizer, options, dims.n_text_ctx)
    if len(initial) > decoder.prompt_width:
        initial = initial[-decoder.prompt_width :]
    sample_begin = len(initial)
    sot_index = initial.index(tokenizer.sot)
    sample_len = options.sample_len or dims.n_text_ctx // 2
    sample_len = min(sample_len, dims.n_text_ctx - sample_begin - 1)

    suppress_mask = torch.zeros(dims.n_vocab, dtype=torch.float32)
    suppress_mask[list(get_suppress_tokens(tokenizer, options))] = float("-inf")
    suppress_mask = suppress_mask.to(dev)
    if options.max_initial_timestamp is None:
        max_init_idx = dims.n_vocab
    else:
        max_init_idx = int(options.max_initial_timestamp / 0.02)

    consts = RuleConsts(
        eot=tokenizer.eot,
        ts_begin=tokenizer.timestamp_begin,
        no_ts=tokenizer.no_timestamps,
        space_tok=tokenizer.encode(" ")[0],
        prompt_width=decoder.prompt_width,
        n_ctx=dims.n_text_ctx,
        use_timestamps=not options.without_timestamps,
        suppress_blank=options.suppress_blank,
    )

    enc_rep = enc.repeat_interleave(beam, dim=0)
    xkv = wm.cross_kv(model, enc_rep, dims)
    cache = wm.init_cache(dims, lanes, dtype=model.dtype, device=dev)

    prompt = np.full((lanes, decoder.prompt_width), tokenizer.eot, np.int64)
    prompt[:, :sample_begin] = initial

    prefill_logits, _, cache = wm.decode(
        model, torch.from_numpy(prompt).to(dev), torch.zeros((lanes,), dtype=torch.long, device=dev),
        xkv, cache, dims,
    )
    no_speech_prob = (
        torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, tokenizer.no_timestamps - 1].cpu().numpy()
    )
    logits = prefill_logits[:, sample_begin - 1]

    eot = tokenizer.eot
    ts_begin = tokenizer.timestamp_begin

    # Host beam state.
    sequences: List[List[int]] = [[] for _ in range(lanes)]
    cum_logprobs = np.zeros(lanes, np.float64)
    # Only lane 0 of each audio is "live" initially so identical beams don't
    # tie (reference seeds all beams equal and dedups via the sequence dict;
    # we instead start the others at -inf).
    for a in range(n_audio):
        for g in range(1, beam):
            cum_logprobs[a * beam + g] = -np.inf
    finished: List[dict] = [{} for _ in range(n_audio)]

    for k in range(sample_len):
        # filter-rule state per lane from host sequences
        last = np.array([s[-1] if s else -1 for s in sequences], np.int64)
        penult = np.array([s[-2] if len(s) > 1 else -1 for s in sequences], np.int64)
        last_ts_arr = np.full(lanes, ts_begin, np.int64)
        has_ts_arr = np.zeros(lanes, bool)
        for i, s in enumerate(sequences):
            tss = [t for t in s if t >= ts_begin]
            if tss:
                last_ts_arr[i] = tss[-1]
                has_ts_arr[i] = True

        flogits = _apply_filters(
            logits, k, torch.from_numpy(last).to(dev), torch.from_numpy(penult).to(dev),
            torch.from_numpy(last_ts_arr).to(dev), torch.from_numpy(has_ts_arr).to(dev),
            suppress_mask, max_init_idx, consts,
        )
        logprobs = torch.log_softmax(flogits, dim=-1).cpu().numpy().astype(np.float64)

        next_tokens = np.zeros(lanes, np.int64)
        src_idx = np.arange(lanes, dtype=np.int64)
        new_sequences: List[List[int]] = [None] * lanes
        new_cum = np.zeros(lanes, np.float64)

        all_done = True
        for a in range(n_audio):
            scores: dict = {}
            sources: dict = {}
            for g in range(beam):
                lane = a * beam + g
                if not np.isfinite(cum_logprobs[lane]):
                    continue
                top = np.argpartition(-logprobs[lane], beam + 1)[: beam + 1]
                for tok in top:
                    seq = tuple(sequences[lane]) + (int(tok),)
                    scores[seq] = cum_logprobs[lane] + logprobs[lane, int(tok)]
                    sources[seq] = lane

            saved = 0
            for seq in sorted(scores, key=scores.get, reverse=True):
                if seq[-1] == eot:
                    if len(finished[a]) < max_candidates:
                        finished[a][seq] = scores[seq]
                    continue
                lane = a * beam + saved
                new_sequences[lane] = list(seq)
                new_cum[lane] = scores[seq]
                next_tokens[lane] = seq[-1]
                src_idx[lane] = sources[seq]
                saved += 1
                if saved == beam:
                    break
            for g in range(saved, beam):
                lane = a * beam + g
                new_sequences[lane] = sequences[lane]
                new_cum[lane] = -np.inf
            if len(finished[a]) < max_candidates:
                all_done = False

        sequences = new_sequences
        cum_logprobs = new_cum
        if all_done or k == sample_len - 1 or sample_begin + k + 1 >= dims.n_text_ctx:
            break

        cache = _reorder_cache(cache, torch.from_numpy(src_idx).to(dev))
        pos = torch.full((lanes,), sample_begin + k, dtype=torch.long, device=dev)
        step_logits, _, cache = wm.decode(
            model, torch.from_numpy(next_tokens).to(dev)[:, None], pos, xkv, cache, dims
        )
        logits = step_logits[:, 0]

    # Drain: unfinished beams count as candidates too (reference finalize).
    for a in range(n_audio):
        if len(finished[a]) == 0:
            for g in range(beam):
                lane = a * beam + g
                if np.isfinite(cum_logprobs[lane]) and sequences[lane]:
                    finished[a][tuple(sequences[lane]) + (eot,)] = cum_logprobs[lane]

    results = []
    for a in range(n_audio):
        best_score, best_seq, best_lp = -np.inf, (), 0.0
        for seq, lp in finished[a].items():
            n = len(seq)
            if options.length_penalty is None:
                penalty = n
            else:
                penalty = ((5 + n) / 6) ** options.length_penalty
            score = lp / max(penalty, 1e-9)
            if score > best_score:
                best_score, best_seq, best_lp = score, seq, lp
        toks = [t for t in best_seq if t != eot]
        text = tokenizer.decode(toks).strip()
        results.append(
            DecodingResult(
                language=language,
                language_probs=lang_probs[a] if lang_probs else None,
                tokens=toks,
                text=text,
                avg_logprob=float(best_lp / max(len(best_seq), 1)),
                no_speech_prob=float(no_speech_prob[a * beam]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
            )
        )
    return results
