"""The decode step's DRY penalty: kernel K4 (``csrc/dry_penalty.cu``) and
its wrapper ``ops/dry.py``.

On the CPU: the wrapper takes the plain version and launches nothing, its
argument checks, and the plain version against the rule the kernel
implements, written once more position by position (``_rule``), on the
planted rows (``harness/dry_cases.py``) the card's test uses. On the card
(``cuda`` marker): the kernel against the plain version bit for bit at the
main path's widths, and ``_tick_core`` at turbo's decoder widths as built
against the same program with the plain version patched in. Imports no
JAX.
"""

import dataclasses

import pytest
import torch

from whisperlivekit_tpu_torch.engine.trace import TRACER
from whisperlivekit_tpu_torch.harness.dry_cases import EOT, KINDS, greedy_loop_args
from whisperlivekit_tpu_torch.harness.dry_cases import planted_rows as _planted
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.ops import dry as D
from whisperlivekit_tpu_torch.streaming import alignatt as A

V_TURBO = 51866  # large-v3-turbo's vocabulary
V_CPU = 50300  # above every planted id, small enough for the CPU tests


def _rule(logits, tokens, cur_len, eot):
    """The kernel's rule, position by position: each candidate walks its own
    match length; of the candidates sharing a next id the longest writes,
    the lowest position among equals."""
    out = logits - torch.zeros(())
    B, V = logits.shape
    L = tokens.shape[1]
    for b in range(B):
        tok = [int(x) for x in tokens[b]]
        end = int(cur_len[b]) - 1
        last = tok[end % L]
        if end + 1 < 5 or last >= eot:
            continue
        run = {}
        for i in range(L):
            nxt = tok[(i + 1) % L]
            if not (i < end and tok[i] == last and nxt < eot):
                continue
            n = 1
            for l in range(1, 50):
                j, k = i - l, end - l
                if j < 0 or k <= i or tok[j] != tok[k % L] or tok[j] >= eot:
                    break
                n += 1
            if n >= 2 and 0 <= nxt < V and n > run.get(nxt, (0, 0))[0]:
                run[nxt] = (n, i)
        for nxt, (n, _) in run.items():
            out[b, nxt] = logits[b, nxt] - 2.0 ** (n - 2)
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# CPU: the wrapper, its checks, the plain version against the kernel's rule
# ---------------------------------------------------------------------------


def test_planted_rows_match_the_kernels_rule_on_cpu():
    """The plain version and the position-by-position rule agree bit for bit
    on every planted kind, and the planted penalties fire where they should."""
    logits, tokens, cur_len = _planted(len(KINDS), V_CPU, 0)
    got = D.dry_penalty_plain(logits, tokens, cur_len, EOT)
    assert torch.equal(_bits(got), _bits(_rule(logits, tokens, cur_len, EOT)))

    def took(kind, tid, exp):  # the id lost exactly 2^exp
        b = KINDS.index(kind)
        return bool(got[b, tid] == logits[b, tid] - torch.tensor(2.0 ** exp))

    assert took("run_20", 123, 19)
    assert took("run_49", 123, 48) and took("run_120", 123, 48)  # 1 + 49: the cap
    assert took("shared_equal", 4242, 11)
    assert took("shared_unequal", 4242, 8) and took("shared_unequal", 31, 2)
    assert took("special_in_chain", 99, 8)  # the special id 10 back ends the run at 10
    assert took("wrap", 555, 2)  # the longest run into column L-1 is 4
    for kind in ("empty", "short", "last_special", "next_special"):
        b = KINDS.index(kind)
        assert torch.equal(_bits(got[b]), _bits(logits[b])), kind


@pytest.mark.parametrize("tok_dtype", [torch.int32, torch.int64])
def test_wrapper_takes_plain_version_on_cpu(tok_dtype):
    """CPU tensors go to the plain version: the same bits, no launch, no
    ``dry.kernel`` count."""
    logits, tokens, cur_len = _planted(len(KINDS), V_CPU, 1)
    before, counted = D.dry_penalty.launches, TRACER.counters.get("dry.kernel", 0)
    got = A.dry_penalty(logits, tokens.to(tok_dtype), cur_len.to(tok_dtype), EOT)
    assert torch.equal(_bits(got), _bits(D.dry_penalty_plain(logits, tokens, cur_len, EOT)))
    assert D.dry_penalty.launches == before
    assert TRACER.counters.get("dry.kernel", 0) == counted


BAD_ARGS = {
    "tokens_1d": (lambda lg, t, c: (lg, t[0], c), ValueError),
    "tokens_rows": (lambda lg, t, c: (lg, t[:-1], c), ValueError),
    "tokens_empty_row": (lambda lg, t, c: (lg, t[:, :0], c), ValueError),
    "cur_len_2d": (lambda lg, t, c: (lg, t, c[:, None]), ValueError),
    "cur_len_rows": (lambda lg, t, c: (lg, t, c[:-1]), ValueError),
    "logits_1d": (lambda lg, t, c: (lg[0], t, c), ValueError),
}
KERNEL_ONLY = {
    "row_past_max_len": (lambda lg, t, c: (lg, torch.zeros(t.shape[0], D.MAX_LEN + 1, dtype=t.dtype), c),
                         ValueError),
    "logits_f64": (lambda lg, t, c: (lg.double(), t, c), TypeError),
    "logits_bf16": (lambda lg, t, c: (lg.bfloat16(), t, c), TypeError),
    "tokens_float": (lambda lg, t, c: (lg, t.float(), c), TypeError),
    "cur_len_int16": (lambda lg, t, c: (lg, t, c.to(torch.int16)), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_wrapper_raises_on_misshaped_args(case):
    """Shapes that do not belong together raise in the wrapper on every
    device, and in the kernel's checks."""
    make, exc = BAD_ARGS[case]
    args = make(*_planted(3, V_CPU, 2))
    with pytest.raises(exc):
        A.dry_penalty(*args, EOT)
    with pytest.raises(exc):
        D.check_args(*args, kernel=True)


@pytest.mark.parametrize("case", sorted(KERNEL_ONLY))
def test_kernel_checks_raise_on_what_the_kernel_does_not_take(case):
    """A row longer than the block holds, logits other than f32 and ids
    other than int32 / int64 are refused before a launch; the plain version
    still takes them on the CPU."""
    make, exc = KERNEL_ONLY[case]
    args = make(*_planted(3, V_CPU, 3))
    with pytest.raises(exc):
        D.check_args(*args, kernel=True)
    D.check_args(*args, kernel=False)
    if case == "row_past_max_len":
        assert A.dry_penalty(*args, EOT).shape == args[0].shape


def test_kernel_max_len_covers_the_text_context():
    assert D.MAX_LEN >= max(d.n_text_ctx for d in MODEL_DIMS.values())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16, 64, 96])  # 16: four sessions x four beams
@pytest.mark.parametrize("ids", ["int64", "int32"])
def test_kernel_matches_plain_on_gpu(B, ids):
    """Bit for bit at L=448, V=51866 on every planted kind, each kind on
    several lanes; a single lane takes the most repetitive kind."""
    _need_cuda()
    if B == 1:
        pick = [KINDS.index("one_token")]
        logits, tokens, cur_len = (t[pick] for t in _planted(len(KINDS), V_TURBO, 1))
    else:
        logits, tokens, cur_len = _planted(B, V_TURBO, B)
    dt = getattr(torch, ids)
    lg, tk, cl = logits.cuda(), tokens.to(dt).cuda(), cur_len.to(dt).cuda()
    want = D.dry_penalty_plain(lg, tk, cl, EOT)
    before, counted = D.dry_penalty.launches, TRACER.counters.get("dry.kernel", 0)
    got = D.dry_penalty(lg, tk, cl, EOT)
    torch.cuda.synchronize()
    assert D.dry_penalty.launches == before + 1
    assert TRACER.counters.get("dry.kernel", 0) == counted + 1
    assert got.dtype == want.dtype and got.shape == want.shape and got.data_ptr() != lg.data_ptr()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got.cpu()), _bits(_rule(logits, tokens, cur_len, EOT)))
    if B >= 8:
        assert (got != lg).any()  # the planted penalties fired


@pytest.mark.cuda
def test_kernel_takes_strided_and_unaligned_logits_on_gpu():
    """A logits view that is not contiguous, and one that starts 4 bytes
    past a 16-byte boundary (the row copy's scalar route), give the plain
    version's bits."""
    _need_cuda()
    logits, tokens, cur_len = _planted(8, V_TURBO, 5)
    lg, tk, cl = logits.cuda(), tokens.cuda(), cur_len.cuda()
    wide = torch.full((8, V_TURBO + 1), 7.0, device="cuda")
    wide[:, 1:] = lg
    for view in (wide[:, 1:], lg.t().contiguous().t()):
        got = D.dry_penalty(view, tk, cl, EOT)
        assert torch.equal(_bits(got), _bits(D.dry_penalty_plain(lg, tk, cl, EOT)))
    flat = torch.empty(8 * V_TURBO + 1, device="cuda")[1:].view(8, V_TURBO)
    flat.copy_(lg)
    assert flat.data_ptr() % 16 == 4
    got = D.dry_penalty(flat, tk, cl, EOT)
    assert torch.equal(_bits(got), _bits(D.dry_penalty_plain(lg, tk, cl, EOT)))


@pytest.mark.cuda
def test_tick_core_with_the_kernel_matches_plain_on_gpu(monkeypatch):
    """``_tick_core`` at large-v3-turbo's decoder widths (4 layers of 1280,
    bf16): as built (the kernel, once a step) against the same loop with the
    plain version patched in, packed outputs equal; and the penalty is what
    decides the tokens (without it they differ)."""
    _need_cuda()
    dims = dataclasses.replace(MODEL_DIMS["large-v3-turbo"], n_audio_layer=1)  # no encoder runs
    model = TM.init_params(dims, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, device="cuda")
    max_steps = 8
    args = greedy_loop_args(8, dims, 64, 1, "cuda")
    before = D.dry_penalty.launches
    built = A._tick_core(model, max_steps=max_steps, **args)
    torch.cuda.synchronize()
    assert D.dry_penalty.launches == before + max_steps  # every lane ran every step
    monkeypatch.setattr(A, "dry_penalty", D.dry_penalty_plain)
    plain = A._tick_core(model, max_steps=max_steps, **args)
    monkeypatch.setattr(A, "dry_penalty", lambda lg, *a: lg)
    without = A._tick_core(model, max_steps=max_steps, **args)
    assert D.dry_penalty.launches == before + max_steps
    assert torch.equal(built, plain)
    assert not torch.equal(built[:, :max_steps], without[:, :max_steps])
