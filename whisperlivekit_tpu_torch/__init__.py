"""whisperlivekit_tpu_torch — the PyTorch/CUDA port of whisperlivekit_tpu.

Mirrors the JAX package's module paths and function names
(``whisperlivekit_tpu.X.Y`` -> ``whisperlivekit_tpu_torch.X.Y``) and keeps
its public layouts, so each port is held against its JAX counterpart by the
``tests/test_torch_*.py`` parity tests. Host-only modules that import no JAX
(config, timed, tokenizer, dims, session alignment/metrics/diff, VAD, web UI)
are imported from the JAX package rather than copied.

Ported so far: the base-form AlignAtt streaming path (models below d=1280)
from ``WS /asr`` down to the encoder flash-attention kernel
(``csrc/flash_encoder.cu``). This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
