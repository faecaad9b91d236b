"""whisperlivekit_tpu_torch — the PyTorch/CUDA port of whisperlivekit_tpu.

Mirrors the JAX package's module paths and function names
(``whisperlivekit_tpu.X.Y`` -> ``whisperlivekit_tpu_torch.X.Y``) and keeps
its public layouts, so each port is held against its JAX counterpart by the
``tests/test_torch_*.py`` parity tests. The host-only modules (config, CLI,
timed records, tokenizer, dims, languages, session alignment/metrics/diff,
ffmpeg, VAD, web page, native PCM runtime) are the port's own copies: it
imports nothing of the JAX package.

Ported so far: the AlignAtt streaming path in its base form (models below
d=1280) and its large form (group cross-KV and self-KV pools), from
``WS /asr`` down to the three hand-written Hopper kernels: encoder and
prefill attention (``csrc/flash_encoder.cu``), the cross-KV pool splice
(``csrc/xkv_splice.cu``) and the fused log-mel front end
(``csrc/log_mel.cu``, behind ``AlignAttConfig.mel_pallas``), with language
auto-detect. The entry points serve on the card and raise without CUDA
unless given ``device="cpu"``. This package imports ``torch`` and never
``jax``.
"""

__version__ = "0.1.0"
