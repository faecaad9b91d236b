"""Command-line interface of the port (port of whisperlivekit_tpu/cli.py).

    python -m whisperlivekit_tpu_torch.cli [serve|listen|run|transcribe|models|pull|rm|check|diagnose|convert] [flags]

(``wlk-torch`` when installed.) The same subcommands and flags as the JAX
package's ``wlk`` (reference cli.py:52-1718); the offline commands
(transcribe/run/diagnose/bench) drive the port's in-process TestHarness.

Device: from the shell every command that builds a model runs it on the card
and fails without CUDA. A Python caller picks the device with
``main(argv, device="cpu")`` (the tests do); there is no flag for it.
Unlike the JAX CLI, ``main`` returns after the offline commands rather than
force-exiting: the scheduler's ticks run on asyncio's default executor,
which ``asyncio.run`` joins before it returns.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time

from .cli_args import build_parser, parse_args
from .models.whisper.dims import HF_REPOS, MODEL_DIMS

logger = logging.getLogger(__name__)

SUBCOMMANDS = (
    "serve", "listen", "run", "transcribe", "bench", "models", "pull", "rm",
    "check", "diagnose", "convert",
)


def _card() -> str:
    """torch, its CUDA and the card, on one line."""
    import torch

    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA device"
    return f"torch {torch.__version__} · cuda {torch.version.cuda or 'none'} · {card}"


def print_banner(config) -> None:
    print(
        f"wlk-torch · whisper-{config.model_path or config.model_size} · "
        f"policy={config.backend_policy} · {_card()} · http://{config.host}:{config.port}",
        file=sys.stderr,
    )


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def cmd_serve(argv, device=None) -> int:
    config = parse_args(argv)
    logging.basicConfig(level=getattr(logging, config.log_level.upper(), logging.INFO))
    print_banner(config)
    from .server.app import WLKServer

    WLKServer(config, device=device).run()
    return 0


def cmd_listen(argv, device=None) -> int:
    print(
        "listen: microphone capture runs in the browser — starting the server; "
        "open the printed URL and press Start.",
        file=sys.stderr,
    )
    return cmd_serve(argv, device)


# ---------------------------------------------------------------------------
# transcribe / run
# ---------------------------------------------------------------------------


def _harness_kwargs(config, device=None) -> dict:
    from dataclasses import asdict

    kw = asdict(config)
    kw["pcm_input"] = True
    if device is not None:
        kw["device"] = device
    return kw


async def _transcribe_file(path: str, config, speed: float, on_update=None, device=None):
    from .harness.harness import TestHarness

    async with TestHarness(**_harness_kwargs(config, device)) as h:
        if on_update:
            h.on_update(on_update)
        await h.feed(path, speed=speed)
        await h.drain(1.0)
        return await h.finish(timeout=max(120.0, 10.0))


def _format_result(state, fmt: str) -> str:
    if fmt in ("text", "txt"):
        return state.text
    lines = [
        {
            "start": ln["start"],
            "end": ln["end"],
            "text": ln["text"],
            "speaker": ln["speaker"],
        }
        for ln in state.speech_lines
    ]
    if fmt == "json":
        return json.dumps({"text": state.text, "lines": lines}, ensure_ascii=False)
    if fmt == "verbose_json":
        return json.dumps(
            {
                "text": state.text,
                "lines": lines,
                "buffer": state.buffer_transcription,
                "timing_valid": state.timing_valid,
            },
            ensure_ascii=False,
            indent=2,
        )
    if fmt == "tsv":
        from .harness.harness import _parse_time

        rows = ["start\tend\ttext"]
        for ln in state.speech_lines:
            rows.append(
                f"{round(1000 * _parse_time(ln['start']))}\t"
                f"{round(1000 * _parse_time(ln['end']))}\t{ln['text'].strip()}"
            )
        return "\n".join(rows)
    if fmt in ("srt", "vtt"):
        from .harness.harness import _parse_time

        out = ["WEBVTT", ""] if fmt == "vtt" else []
        for i, ln in enumerate(state.speech_lines, start=1):
            s, e = _parse_time(ln["start"]), _parse_time(ln["end"])

            def ts(x):
                h, rem = divmod(int(x * 1000), 3600000)
                m, rem = divmod(rem, 60000)
                sec, ms = divmod(rem, 1000)
                sep = "," if fmt == "srt" else "."
                return f"{h:02d}:{m:02d}:{sec:02d}{sep}{ms:03d}"

            if fmt == "srt":
                out.append(str(i))
            out.append(f"{ts(s)} --> {ts(e)}")
            out.append(ln["text"].strip())
            out.append("")
        return "\n".join(out)
    raise ValueError(f"unknown output format: {fmt}")


def _pop_flag(argv, name, default=None):
    if name in argv:
        i = argv.index(name)
        val = argv[i + 1]
        del argv[i : i + 2]
        return val
    return default


def cmd_transcribe(argv, device=None) -> int:
    if not argv or argv[0].startswith("-"):
        print("usage: wlk-torch transcribe FILE [--output-format text|json|srt|vtt] [flags]", file=sys.stderr)
        return 2
    path = argv.pop(0)
    fmt = _pop_flag(argv, "--output-format", "text")
    config = parse_args(argv)
    logging.basicConfig(level=logging.ERROR)
    state = asyncio.run(_transcribe_file(path, config, speed=0, device=device))
    print(_format_result(state, fmt))
    return 0


def cmd_run(argv, device=None) -> int:
    """Stream a file at real-time speed, printing incremental updates."""
    if not argv or argv[0].startswith("-"):
        print("usage: wlk-torch run FILE [flags]", file=sys.stderr)
        return 2
    path = argv.pop(0)
    speed = float(_pop_flag(argv, "--speed", "1.0"))
    config = parse_args(argv)
    logging.basicConfig(level=logging.ERROR)

    def show(state):
        sys.stdout.write("\r\x1b[K" + state.text[-120:])
        sys.stdout.flush()

    state = asyncio.run(_transcribe_file(path, config, speed=speed, on_update=show, device=device))
    print("\n--- final ---")
    print(state.text)
    return 0


# ---------------------------------------------------------------------------
# models / pull / rm / check / convert
# ---------------------------------------------------------------------------


def cmd_models(argv, device=None) -> int:
    from .models.whisper.load import _resolve_size_to_path

    print(f"{'size':<16} {'params':<10} {'local':<8} repo")
    for name, dims in MODEL_DIMS.items():
        if name == "dev-tiny":
            continue
        approx = (
            dims.n_audio_layer * 12 * dims.n_audio_state**2
            + dims.n_text_layer * 16 * dims.n_text_state**2
        ) / 1e6
        local = _resolve_size_to_path(name, None)
        print(f"{name:<16} {approx:,.0f}M{'':<4} {'yes' if local else '-':<8} "
              f"{HF_REPOS.get(name, '-')}")
    return 0


def cmd_pull(argv, device=None) -> int:
    if not argv:
        print("usage: wlk-torch pull SIZE", file=sys.stderr)
        return 2
    size = argv[0]
    extra = {
        "voxtral": "mistralai/Voxtral-Mini-3B-2507",
        "voxtral-realtime": "mistralai/Voxtral-Mini-4B-Realtime-2510",
        "nllb": "facebook/nllb-200-distilled-600M",
        "nllb-1.3B": "facebook/nllb-200-distilled-1.3B",
        "sortformer": "nvidia/diar_streaming_sortformer_4spk-v2",
        "qwen3-causal": "qfuxa/qwen3-asr-0.6b-streaming",
    }
    repo = HF_REPOS.get(size) or extra.get(size)
    if repo is None:
        print(f"unknown model size {size!r}; see `wlk-torch models`", file=sys.stderr)
        return 2
    try:
        from huggingface_hub import snapshot_download

        path = snapshot_download(repo)
        print(f"downloaded {repo} -> {path}")
        return 0
    except Exception as e:
        print(f"download failed ({e}); network access required", file=sys.stderr)
        return 1


def cmd_rm(argv, device=None) -> int:
    if not argv:
        print("usage: wlk-torch rm SIZE", file=sys.stderr)
        return 2
    import shutil

    from .models.whisper.load import _resolve_size_to_path

    path = _resolve_size_to_path(argv[0], None)
    if path is None:
        print(f"no local weights for {argv[0]}")
        return 1
    target = path if path.is_file() else path.parent.parent
    shutil.rmtree(target, ignore_errors=True) if target.is_dir() else target.unlink()
    print(f"removed {target}")
    return 0


def cmd_check(argv, device=None) -> int:
    """Environment report: torch, CUDA, the card and one matmul on it (or on
    ``device`` when a caller names one). Fails without CUDA, saying so."""
    import torch

    ok = True
    print(f"python: {sys.version.split()[0]}")
    print(f"torch: {_card()}")
    try:
        from .models.whisper.tokenizer import find_vocab_file

        print(f"tokenizer assets: {find_vocab_file('multilingual')}")
    except FileNotFoundError as e:
        ok = False
        print(f"tokenizer assets: MISSING ({e})")
    from .audio.io import ffmpeg_available
    from .audio.vad import find_silero_jit

    print(f"ffmpeg: {'yes' if ffmpeg_available() else 'no (WAV/PCM only)'}")
    print(f"silero vad weights: {find_silero_jit() or 'no (energy VAD fallback)'}")
    if device is None and not torch.cuda.is_available():
        print("device matmul: FAILED (no CUDA device: the port serves on the GPU)")
        return 1
    dev = torch.device(device) if device is not None else torch.device("cuda")
    x = torch.ones((128, 128), device=dev)
    (x @ x).sum().item()
    print(f"device matmul: ok ({dev})")
    return 0 if ok else 1


def cmd_convert(argv, device=None) -> int:
    """Convert OpenAI/HF weights to the port's native format (fast loads)."""
    if len(argv) < 2:
        print("usage: wlk-torch convert SIZE_OR_PATH OUT_DIR [--dtype bfloat16]", file=sys.stderr)
        return 2
    src, out = argv[0], argv[1]
    dtype_name = _pop_flag(argv, "--dtype", "bfloat16")
    import torch

    from .models.whisper.load import load_model, save_native

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype_name]
    model, dims, name = load_model(src, dtype=dtype, device=device)
    save_native(model, dims, out)
    print(f"converted {name or src} -> {out} ({dtype_name})")
    return 0


# ---------------------------------------------------------------------------
# bench / diagnose
# ---------------------------------------------------------------------------


def cmd_bench(argv, device=None) -> int:
    from .bench.runner import main as bench_main

    return bench_main(argv, device)


def cmd_diagnose(argv, device=None) -> int:
    """Feed audio while probing pipeline internals; pass/fail health checks
    (reference cli.py:1220-1612: RTF < 2, non-empty output, monotonic)."""
    if not argv or argv[0].startswith("-"):
        print("usage: wlk-torch diagnose FILE [flags]", file=sys.stderr)
        return 2
    path = argv.pop(0)
    config = parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    async def run_diagnose():
        import numpy as _np

        from .harness.harness import TestHarness

        t0 = time.time()
        # warm a throwaway session first so the timed run (and the RTF < 2
        # health bar) measures inference, not the first tick's kernel builds;
        # VAD is off for the warm pass (pure-silence audio would never open
        # the gate) and finish() forces is_last
        warm_kwargs = {**_harness_kwargs(config, device), "vac": False}
        async with TestHarness(**warm_kwargs) as warm:
            pcm = _np.zeros(16000 * 3, _np.int16).tobytes()
            await warm.feed_pcm(pcm, speed=0)
            await warm.finish(timeout=600)
        load_time = time.time() - t0
        async with TestHarness(**_harness_kwargs(config, device)) as h:
            probes = []

            def probe(state):
                probes.append(
                    {
                        "t": h.audio_position,
                        "lines": len(state.lines),
                        "buffer": len(state.buffer_transcription),
                        "lag": state.remaining_time_transcription,
                        # pipeline + backend internals (queue depths,
                        # window/cache state, scheduler quantiles —
                        # reference cli.py:1253-1347 probe depth)
                        **h.probe(),
                    }
                )

            h.on_update(probe)
            t1 = time.time()
            await h.feed(path, speed=0)
            await h.drain(2.0)
            final = await h.finish(timeout=120)
            processing = time.time() - t1
            audio_s = h.audio_position
            rtf = processing / audio_s if audio_s else 0.0

            checks = {
                "model_load_under_300s": load_time < 300,
                "rtf_under_2": rtf < 2.0,
                "output_non_empty": bool(final.text.strip()),
                "timing_monotonic": final.timing_monotonic,
                "timing_valid": final.timing_valid,
            }
            print(f"load={load_time:.1f}s audio={audio_s:.1f}s processing={processing:.1f}s rtf={rtf:.3f}")
            print(f"probes={len(probes)} metrics={h.metrics.to_dict()}")
            if probes:
                last = probes[-1]
                print(f"backend={json.dumps(last.get('backend', {}))}")
                depths = {k: v for k, v in last.items() if k.endswith('_queue_depth')}
                print(f"pipeline={json.dumps({**depths, 'in_silence': last.get('in_silence'), 'n_state_tokens': last.get('n_state_tokens')})}")
            failed = [k for k, v in checks.items() if not v]
            for k, v in checks.items():
                print(f"  [{'PASS' if v else 'FAIL'}] {k}")
            return 0 if not failed else 1

    return asyncio.run(run_diagnose())


# ---------------------------------------------------------------------------


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        cmd = argv.pop(0)
    elif argv and argv[0] in ("-h", "--help"):
        print(f"usage: wlk-torch [{'|'.join(SUBCOMMANDS)}] [flags]\n")
        build_parser(prog="wlk-torch").print_help()
        return 0
    else:
        cmd = "serve"  # default falls through to serve (reference cli.py:1667)
    return globals()[f"cmd_{cmd}"](argv, device)


if __name__ == "__main__":
    sys.exit(main())
