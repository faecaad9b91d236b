"""The port's CLI (whisperlivekit_tpu_torch/cli.py) and WS test client on the
CPU. A Python caller picks the device with ``main(argv, device="cpu")``;
from the shell every command runs on the card.

- ``transcribe FILE --model-path ckpt.pt`` prints what the JAX package's
  ``wlk transcribe`` prints for the same dev-tiny checkpoint and WAV;
- ``run``, ``diagnose``, ``models``, ``convert``, ``serve``/``listen`` (the
  server's run stubbed), ``pull`` and ``rm`` (over a fake cache, stopping
  before any fetch), ``check`` with and without CUDA, ``bench`` (its usage error; the runs
  are in test_torch_bench.py);
- ``test_client.transcribe_audio`` against the port's server.
"""

import asyncio
import inspect
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from whisperlivekit_tpu import cli as JC
from whisperlivekit_tpu.harness import harness as JH
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch import cli as TC
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from torch_ckpt import canonical_state_dict, write_openai, write_wav

from conftest import REPO_ROOT

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ckpt = write_openai(root / "tiny.pt", canonical_state_dict(MODEL_DIMS["dev-tiny"], seed=9),
                        MODEL_DIMS["dev-tiny"], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(root / "vocab").parent))
        mp.setenv("HOME", str(root / "home"))  # no local weights cache
        yield dict(ckpt=str(ckpt), wav=str(write_wav(root / "speech.wav", 3.0, seed=21)), root=root)
    JH.reset_engine_cache()
    TH.reset_engine_cache()


def flags(assets):
    return ["--model-path", assets["ckpt"], "--lan", "en", "--no-vac", "--param-dtype", "float32"]


@pytest.mark.parametrize("fmt", ["text", "json", "srt"])
def test_transcribe_prints_the_jax_text(assets, capsys, fmt):
    argv = [assets["wav"], "--output-format", fmt, *flags(assets)]
    assert JC.cmd_transcribe(list(argv)) == 0
    jax_out = capsys.readouterr().out
    assert TC.main(["transcribe", *argv], device="cpu") == 0
    out = capsys.readouterr().out
    assert out == jax_out and out.strip()


def test_run_and_diagnose(assets, capsys):
    assert TC.main(["transcribe", assets["wav"], *flags(assets)], device="cpu") == 0
    text = capsys.readouterr().out.strip()
    assert TC.main(["run", assets["wav"], "--speed", "0", *flags(assets)], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.split("--- final ---\n")[1].strip() == text
    rc = TC.main(["diagnose", assets["wav"], *flags(assets)], device="cpu")
    out = capsys.readouterr().out
    for check in ("model_load_under_300s", "rtf_under_2", "output_non_empty", "timing_monotonic"):
        assert f"] {check}" in out
    assert rc == (0 if "[FAIL]" not in out else 1)
    assert "backend_type" in out and "simulstreaming" in out


def test_usage_and_help(assets, capsys):
    for cmd in ("transcribe", "run", "diagnose", "pull", "rm", "convert"):
        assert TC.main([cmd], device="cpu") == 2
    assert "usage: wlk-torch" in capsys.readouterr().err
    assert TC.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "usage: wlk-torch [serve|listen|run|transcribe|bench" in out and "--model-path" in out
    assert TC.main(["bench"], device="cpu") == 2
    assert "usage: wlk-torch bench --audio FILE" in capsys.readouterr().err


def test_public_names_match_jax():
    public = [sorted(n for n, v in vars(m).items() if not n.startswith("_") and not inspect.ismodule(v))
              for m in (JC, TC)]
    assert public[1] == public[0]
    assert TC.SUBCOMMANDS == JC.SUBCOMMANDS


def test_models_matches_jax(assets, capsys):
    assert JC.cmd_models([]) == 0
    jax_out = capsys.readouterr().out
    assert TC.main(["models"]) == 0
    out = capsys.readouterr().out
    assert out == jax_out and "large-v3-turbo" in out and "tiny" in out


def test_check_without_cuda_fails_and_says_why(assets, capsys, monkeypatch):
    assert TC.main(["check"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "torch: torch " in out and "device matmul: ok (cpu)" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TC.main(["check"]) == 1
    assert "device matmul: FAILED (no CUDA device" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TC.main(["transcribe", assets["wav"], *flags(assets)])


def test_shell_entry_uses_the_card(assets):
    proc = subprocess.run([sys.executable, "-m", "whisperlivekit_tpu_torch.cli", "check"], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        assert proc.returncode == 0 and "device matmul: ok (cuda)" in proc.stdout, proc.stderr[-2000:]
    else:
        assert proc.returncode == 1 and "no CUDA device" in proc.stdout, proc.stderr[-2000:]


def test_serve_and_listen_build_the_server_on_the_device(assets, monkeypatch, capsys):
    from whisperlivekit_tpu_torch.server import app

    ran = []
    monkeypatch.setattr(app.WLKServer, "run", lambda self: ran.append((self.config.model_path, self.device)))
    assert TC.main(["serve", *flags(assets), "--port", "9123"], device="cpu") == 0
    assert TC.main(["listen", *flags(assets)], device="cpu") == 0
    assert TC.main([*flags(assets)], device="cpu") == 0  # no subcommand: serve
    assert ran == [(assets["ckpt"], "cpu")] * 3
    err = capsys.readouterr().err
    assert "wlk-torch · whisper-" in err and ":9123" in err and "microphone capture" in err


def test_convert_writes_the_native_format(assets):
    from whisperlivekit_tpu_torch.models.whisper.load import detect_format, load_model

    out = assets["root"] / "native"
    assert TC.main(["convert", assets["ckpt"], str(out), "--dtype", "float32"], device="cpu") == 0
    assert detect_format(out) == "native"
    got, dims, _ = load_model(str(out), dtype=torch.float32, device="cpu")
    want, wdims, _ = load_model(assets["ckpt"], dtype=torch.float32, device="cpu")
    assert dims == wdims
    for (n, a), (_, b) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), n


def test_pull_stops_before_any_fetch(assets, monkeypatch, capsys):
    calls = []

    def snapshot_download(repo):
        calls.append(repo)
        if repo.endswith("small"):
            raise OSError("offline")
        return f"/cache/{repo}"

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(snapshot_download=snapshot_download))
    assert TC.main(["pull", "large-v3-turbo"]) == 0
    assert "downloaded openai/whisper-large-v3-turbo -> /cache/openai/whisper-large-v3-turbo" in capsys.readouterr().out
    assert TC.main(["pull", "small"]) == 1
    assert "network access required" in capsys.readouterr().err
    assert TC.main(["pull", "no-such-size"]) == 2
    assert calls == ["openai/whisper-large-v3-turbo", "openai/whisper-small"]


def test_rm_removes_local_weights(assets, monkeypatch, capsys):
    home = assets["root"] / "rm_home"
    (home / ".cache" / "whisper").mkdir(parents=True)
    (home / ".cache" / "whisper" / "tiny.pt").write_bytes(b"x")
    repo = home / ".cache" / "huggingface" / "hub" / "models--openai--whisper-base"
    (repo / "snapshots" / "abc").mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    assert TC.main(["rm", "tiny"]) == 0 and not (home / ".cache" / "whisper" / "tiny.pt").exists()
    assert TC.main(["rm", "base"]) == 0 and not repo.exists()
    assert TC.main(["rm", "small"]) == 1
    assert "no local weights for small" in capsys.readouterr().out


def test_ws_test_client_against_the_port_server(assets):
    """``wlk-test-torch``'s library call streams the WAV (read by the port's
    load_audio_pcm) over WS /asr; it gets the harness's transcript."""
    from aiohttp.test_utils import TestServer

    from whisperlivekit_tpu_torch import test_client
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.server.app import WLKServer

    TranscriptionEngine.reset()
    config = WLKConfig(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32",
                       pcm_input=True, log_level="ERROR")
    engine = TranscriptionEngine(config, device="cpu")
    TranscriptionEngine.reset()

    async def main():
        server = TestServer(WLKServer(config, engine=engine).app)
        await server.start_server()
        try:
            return await test_client.transcribe_audio(
                assets["wav"], url=f"ws://{server.host}:{server.port}/asr", speed=0, chunk_duration=30.0)
        finally:
            await server.close()

    result = asyncio.run(main())
    assert result.finished and result.messages[0]["type"] == "config"
    words = result.text.split()
    assert words and words == " ".join(
        ln["text"] for ln in result.lines if ln.get("text")).split() + result.buffer_transcription.split()
