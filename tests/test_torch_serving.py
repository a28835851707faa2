"""The port's grammar-constrained serving stack against the JAX package, on
the CPU.

Tables, DFA states, tokens and the positions a mask sets to the masked value
are exact, so they are compared bit for bit.  Greedy generation shares the
JAX ``api.init`` weights of the reduced tinyllama-1.1b config (through
``params_from_jax``); both packages are teacher-forced on JAX's greedy
tokens, and each decision is compared wherever JAX's masked logits separate
the top two tokens by more than the 5e-2 logit tolerance, so that the
equality means something.
"""

import ast
import io
import os
import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config, reduce_for_smoke
from repro.core import compile_regex as j_compile_regex
from repro.models import api as japi
from repro.models import transformer as JTF
from repro.serving import GrammarConstraint as JGC
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.core import compile_regex
from repro_torch.kernels import token_mask
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import transformer as TTF
from repro_torch.serving import GrammarConstraint, ServeConfig, ServingEngine

GRAMMAR = r"([0-9]{1,6}[.,] )*[0-9]{0,6}"
EOS = 258
LOGIT_TOL = 5e-2


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.dtype == torch.float32
                      else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


def grammar_prompts(rng, b: int, t: int) -> np.ndarray:
    """[b, t] byte prompts made of ``GRAMMAR``'s groups, cut at t: every
    row is a live prefix of the grammar."""
    rows = []
    for _ in range(b):
        s = b""
        while len(s) < t:
            digits = rng.choice(np.frombuffer(b"0123456789", np.uint8),
                                size=int(rng.integers(1, 7)))
            sep = rng.choice(np.frombuffer(b".,", np.uint8), size=1)
            s += digits.tobytes() + sep.tobytes() + b" "
        rows.append(np.frombuffer(s[:t], np.uint8).astype(np.int32))
    return np.stack(rows)


def _pair(pattern, vocab, **kw):
    return (JGC(j_compile_regex(pattern), vocab, **kw),
            GrammarConstraint(compile_regex(pattern), vocab, device="cpu",
                              **kw))


@pytest.mark.parametrize("pattern,vocab,kw", [
    (GRAMMAR, 512, {}), (r"[a-d]+x", 300, {"allow_specials": (256, 299)}),
    ("(ab)*a?", 200, {"eos_id": 258}), (r"[0-9]{1,6}(\.[0-9]{1,4})?", 320,
                                        {"eos_id": None})])
def test_grammar_tables_match_jax(pattern, vocab, kw):
    jgc, tgc = _pair(pattern, vocab, **kw)
    assert tgc.allowed.dtype == torch.uint8 and tgc.tok_cls.dtype == torch.int32
    np.testing.assert_array_equal(tgc.allowed.numpy(), np.asarray(jgc.allowed))
    np.testing.assert_array_equal(tgc.tok_cls.numpy(), np.asarray(jgc.tok_cls))
    np.testing.assert_array_equal(tgc.table.numpy(), np.asarray(jgc.table_j))
    np.testing.assert_array_equal(tgc.init_states(3).numpy(),
                                  np.asarray(jgc.init_states(3)))


def test_advance_paths_match_jax():
    """``advance`` per token, ``advance_tokens`` (-> ``advance_classes``)
    over whole blocks, specials included, and the empty block."""
    jgc, tgc = _pair("(ab)*a?", 300)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 300, size=(5, 12)).astype(np.int32)
    toks[:, ::3] = rng.choice(np.frombuffer(b"ab", np.uint8), size=(5, 4))
    js, ts = jgc.init_states(5), tgc.init_states(5)
    for t in range(toks.shape[1]):
        js = jgc.advance(js, jnp.asarray(toks[:, t]))
        ts = tgc.advance(ts, torch.from_numpy(toks[:, t]))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = tgc.advance_tokens(tgc.init_states(5), toks)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jgc.advance_tokens(jgc.init_states(5), toks)))
    np.testing.assert_array_equal(got.numpy(), ts.numpy())
    empty = tgc.advance_tokens(tgc.init_states(5), np.zeros((5, 0), np.int32))
    np.testing.assert_array_equal(empty.numpy(), tgc.init_states(5).numpy())
    with pytest.raises(ValueError):
        tgc.advance_tokens(tgc.init_states(5), toks[0])


def test_matcher_advance_classes_matches_jax():
    from repro.core import Matcher as JMatcher
    from repro_torch.core import Matcher

    rng = np.random.default_rng(3)
    dfa_j, dfa_t = j_compile_regex(GRAMMAR), compile_regex(GRAMMAR)
    jm = JMatcher(dfa_j, num_chunks=1, batch_tile=1)
    tm = Matcher(dfa_t, num_chunks=1, batch_tile=1, device="cpu")
    assert tm.pad_cls == jm.pad_cls
    states = rng.integers(0, dfa_t.n_states, size=6).astype(np.int32)
    classes = rng.integers(0, tm.pad_cls + 1, size=(6, 9)).astype(np.int32)
    want = np.asarray(jm.advance_classes(jnp.asarray(states), classes))
    got = tm.advance_classes(torch.from_numpy(states), classes)
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # pad_cls columns are identity moves
    ident = np.full((6, 4), tm.pad_cls, np.int32)
    np.testing.assert_array_equal(tm.advance_classes(states, ident).numpy(),
                                  states)


def test_verify_draft_matches_jax():
    jgc, tgc = _pair(r"[a-d]+x", 512)
    for draft in (b"abz", b"abcdx", b"", b"dddd"):
        d = np.frombuffer(draft, np.uint8)
        jn, jt = jgc.verify_draft(jgc.dfa.start, d)
        tn, tt = tgc.verify_draft(tgc.dfa.start, d)
        assert tn == jn
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_logits_matches_jax(use_kernel, dtype):
    """The masked logits, bit for bit, with the model vocab padded past the
    constraint's (the padded ids are disallowed)."""
    jgc, tgc = _pair(GRAMMAR, 300, use_kernel=use_kernel)
    rng = np.random.default_rng(8)
    states = rng.integers(0, jgc.dfa.n_states, size=4).astype(np.int32)
    logits = rng.normal(size=(4, 320)).astype(np.float32)
    want = jgc.mask_logits(jnp.asarray(states),
                           jnp.asarray(logits).astype(jnp.dtype(dtype)))
    token_mask.reset_launches()
    got = tgc.mask_logits(torch.from_numpy(states),
                          torch.from_numpy(logits).to(getattr(torch, dtype)))
    assert token_mask.launches["token_mask"] == 0   # no kernel on the CPU
    np.testing.assert_array_equal(_bits(got), _bits(want))
    neg = _bits(jnp.asarray(-1e30, jnp.dtype(dtype)))
    masked = _bits(got) == neg
    allowed = np.pad(np.asarray(jgc.allowed), ((0, 0), (0, 20)))[states]
    np.testing.assert_array_equal(masked, allowed == 0)


def test_decode_stream_matches_one_shot_and_jax():
    """Fed in chunks, the stream's states equal a one-shot
    ``advance_tokens`` and JAX's stream."""
    jgc, tgc = _pair(r"[a-d]+x", 300)
    rng = np.random.default_rng(46)
    toks = rng.integers(0, 300, size=(4, 12)).astype(np.int32)
    toks[:2] = rng.choice(np.frombuffer(b"abcd", np.uint8), size=(2, 12))
    want = tgc.advance_tokens(tgc.init_states(4), toks)
    tds, jds = tgc.open_decode(4), jgc.open_decode(4)
    assert tds.stream.matcher.num_chunks == 1   # the seq lowering
    for lo in range(0, 12, 3):           # chunked upload, 3 tokens at a time
        got = tds.feed_tokens(toks[:, lo:lo + 3])
        jgot = jds.feed_tokens(toks[:, lo:lo + 3])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(tds.states.numpy(), want.numpy())
    assert tds.stream.stats.ticks == jds.stream.stats.ticks
    assert tds.stream.stats.evicted == jds.stream.stats.evicted
    with pytest.raises(ValueError):
        tds.feed_tokens(toks[:3])


def test_unported_serving_options_raise():
    """``swap_grammar`` is ported (its tables equal JAX's after the swap);
    the engine serves the transformer families and refuses the others, as
    the JAX engine asserts."""
    jgc, tgc = _pair(GRAMMAR, 300)
    assert tgc.swap_grammar(compile_regex(GRAMMAR)) is False
    assert jgc.swap_grammar(j_compile_regex(GRAMMAR)) is False
    assert tgc.swap_grammar(compile_regex("ab")) is True
    assert jgc.swap_grammar(j_compile_regex("ab")) is True
    np.testing.assert_array_equal(tgc.allowed.numpy(), np.asarray(jgc.allowed))
    np.testing.assert_array_equal(tgc.tok_cls.numpy(), np.asarray(jgc.tok_cls))
    np.testing.assert_array_equal(tgc.table.numpy(), np.asarray(jgc.table_j))
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config(
        "granite-moe-1b-a400m"))
    params = tapi.init(cfg, 0, device="cpu")
    assert ServingEngine(cfg, params, constraint=tgc).device.type == "cpu"
    for arch in ("recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium"):
        cfg = tconfigs.get_config(arch)
        with pytest.raises(AssertionError):
            JServingEngine(get_config(arch), {})
        with pytest.raises(ValueError, match="dense"):
            ServingEngine(cfg, {}, constraint=tgc)


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    jparams = japi.init(cfg, jax.random.PRNGKey(0))
    tcfg = reduce_for_smoke(tconfigs.get_config("tinyllama-1.1b"))
    tparams = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return cfg, jparams, tcfg, tparams


def _jax_greedy_trace(cfg, params, jgc, prompts, n):
    """JAX's constrained greedy decode step by step, as its engine runs it:
    the tokens and each step's top-2 margin of the masked f32 logits."""
    b, t = prompts.shape
    cache = JTF.init_cache(cfg, b, t + n)
    logits, cache, _ = JTF.forward(params, cfg, jnp.asarray(prompts),
                                   cache=cache)
    states = jgc.advance_tokens(jgc.init_states(b), prompts)
    last = logits[:, -1]
    toks, margins = [], []
    for i in range(n):
        masked = np.asarray(jgc.mask_logits(states, last),
                            np.float32)[:, :cfg.vocab_size]
        top2 = np.sort(masked, axis=1)[:, -2:]
        tok = masked.argmax(axis=1).astype(np.int32)
        toks.append(tok)
        margins.append(top2[:, 1] - top2[:, 0])
        states = jgc.advance(states, jnp.asarray(tok))
        last, cache = JTF.decode_step(params, cfg, cache,
                                      jnp.asarray(tok[:, None]),
                                      jnp.int32(t + i))
        last = last[:, -1]
    return np.stack(toks, 1), np.stack(margins, 1)


@pytest.mark.parametrize("eos_id", [EOS, None])
def test_generate_greedy_constrained_matches_jax(model, eos_id):
    """With ``eos_id=None`` the grammar never lets a row end, so every row
    runs all ``n`` decode steps."""
    cfg, jparams, tcfg, tparams = model
    b, t, n = 4, 32, 8
    prompts = grammar_prompts(np.random.default_rng(0), b, t)
    jgc = JGC(j_compile_regex(GRAMMAR), cfg.padded_vocab, eos_id=eos_id)
    tgc = GrammarConstraint(compile_regex(GRAMMAR), cfg.padded_vocab,
                            eos_id=eos_id, device="cpu")
    want = JServingEngine(cfg, jparams, JServeConfig(max_new_tokens=n),
                          constraint=jgc).generate(prompts)
    token_mask.reset_launches()
    got = ServingEngine(tcfg, tparams, ServeConfig(max_new_tokens=n),
                        constraint=tgc).generate(prompts)
    assert got.shape == want.shape == (b, n) and got.dtype == np.int32
    assert token_mask.launches["token_mask"] == 0   # no kernel on the CPU

    # every row, with its prompt, is a live prefix of the grammar
    dfa = tgc.dfa
    for p, row in zip(prompts, got):
        gen = row[:np.argmax(row == EOS)] if (row == EOS).any() else row
        assert (gen < 256).all()
        data = np.concatenate([p, gen]).astype(np.uint8)
        state = dfa.start
        for c in dfa.classes_of(data):
            state = int(dfa.table[state, int(c)])
        assert state != dfa.sink
        if (row == EOS).any():
            assert dfa.accepting[state] or not np.asarray(jgc.allowed)[
                state, :256].any()

    # greedy equality: both packages teacher-forced on JAX's tokens, each
    # live row's decision compared wherever JAX's masked logits separate the
    # top two tokens by more than the tolerance (a nearer pair may go either
    # way within it, so that decision alone is skipped)
    toks, margins = _jax_greedy_trace(cfg, jparams, jgc, prompts, n)
    live = ~_after_eos(toks)
    np.testing.assert_array_equal(np.where(live, toks, EOS), want)
    port = _port_forced_argmax(tcfg, tparams, tgc, prompts, toks)
    separated = live & (margins > LOGIT_TOL)
    np.testing.assert_array_equal(port[separated], toks[separated])
    compared, decisions = int(separated.sum()), int(live.sum())
    print(f"greedy decisions compared: {compared} of {decisions}")
    assert compared >= 0.75 * decisions, (
        f"only {compared} of {decisions} decisions were separated")
    # the port's own greedy run follows JAX's up to the first near-tie
    tie = np.flatnonzero((live & ~separated).any(axis=0))
    stop = int(tie[0]) if tie.size else n
    np.testing.assert_array_equal(got[:, :stop], want[:, :stop])


def _after_eos(toks):
    """[B, n] bool: the steps after a row's first EOS."""
    eos = toks == EOS
    return np.cumsum(eos, axis=1) - eos > 0


def _port_forced_argmax(cfg, params, tgc, prompts, toks):
    """The port's masked-logit argmax at every step, fed ``toks`` (JAX's
    greedy tokens) instead of its own: [B, n] int32."""
    b, t = prompts.shape
    n = toks.shape[1]
    tp = torch.from_numpy(prompts)
    cache = TTF.init_cache(cfg, b, t + n, device="cpu")
    logits, cache, _ = TTF.forward(params, cfg, tp, cache=cache,
                                   last_only=True)
    states = tgc.advance_tokens(tgc.init_states(b), tp)
    last = logits[:, -1].float()
    out = []
    for i in range(n):
        masked = tgc.mask_logits(states, last)[:, :cfg.vocab_size]
        out.append(masked.argmax(dim=1).numpy().astype(np.int32))
        tok = torch.from_numpy(toks[:, i])
        states = tgc.advance(states, tok)
        last, cache = TTF.decode_step(params, cfg, cache, tok[:, None], t + i)
        last = last[:, -1].float()
    return np.stack(out, 1)


def test_generate_kernel_flag_and_stream_agree(model):
    """``use_kernel`` off gives the same tokens; a chunked ``DecodeStream``
    handed to ``generate`` gives the same tokens as the one-shot prefill."""
    _, _, tcfg, tparams = model
    prompts = grammar_prompts(np.random.default_rng(1), 3, 24)
    outs = []
    for use_kernel in (True, False):
        tgc = GrammarConstraint(compile_regex(GRAMMAR), tcfg.padded_vocab,
                                use_kernel=use_kernel, device="cpu")
        outs.append(ServingEngine(tcfg, tparams, ServeConfig(
            max_new_tokens=6), constraint=tgc).generate(prompts))
    np.testing.assert_array_equal(outs[0], outs[1])
    ds = tgc.open_decode(3)
    for lo in range(0, 24, 5):
        ds.feed_tokens(prompts[:, lo:lo + 5])
    np.testing.assert_array_equal(
        ds.states.numpy(),
        tgc.advance_tokens(tgc.init_states(3), prompts).numpy())
    eng = ServingEngine(tcfg, tparams, ServeConfig(max_new_tokens=6),
                        constraint=tgc)
    np.testing.assert_array_equal(eng.generate(prompts, decode_stream=ds),
                                  outs[0])
    with pytest.raises(ValueError):
        eng.generate(prompts[:2], decode_stream=ds)
    sampled = ServingEngine(tcfg, tparams, ServeConfig(
        max_new_tokens=4, temperature=1.0)).generate(prompts, seed=3)
    assert sampled.shape == (3, 4)
    assert ((sampled >= 0) & (sampled < tcfg.vocab_size)).all()


def test_launch_serve_on_cpu(tmp_path):
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--smoke", "--max-new", "4", "--prompts",
            "12", "7.", "--grammar", r"[0-9]{1,6}(\.[0-9]{1,4})?"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
        serve.main(argv + ["--stream", "--chunk-bytes", "1"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("'12' -> ") and lines[1].startswith("'7.' -> ")
    assert any(line.startswith("[stream] prefill") for line in lines)
    # --snapshot-dir publishes one step a chunk round; a fresh decode stream
    # restored from the last one holds the whole prompts' prefill states
    snap = str(tmp_path / "snap")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv + ["--stream", "--chunk-bytes", "1",
                           "--snapshot-dir", snap])
    rounds = [line for line in buf.getvalue().splitlines()
              if line.startswith("[stream] snapshot round")]
    assert rounds == [f"[stream] snapshot round {c}: "
                      f"{os.path.join(snap, f'step_{c:08d}')}"
                      for c in range(2)]
    assert sorted(os.listdir(snap)) == ["step_00000000", "step_00000001"]
    gc = GrammarConstraint(compile_regex(argv[-1]), 512, device="cpu")
    ds = gc.open_decode(2)
    for sess in ds.sessions:      # sids 0, 1 are the snapshot's: free them
        sess.close()
    ds.sessions = ds.stream.restore(snap)
    prompts = torch.tensor([list(b"12"), list(b"7.")], dtype=torch.int32)
    np.testing.assert_array_equal(
        ds.states.numpy(),
        gc.advance_tokens(gc.init_states(2), prompts).numpy())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_launch_serve_moe_and_vlm_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <moe|vlm> --device cpu
    --smoke --grammar ...``: every completion extends its prompt within the
    grammar."""
    grammar = r"[0-9]{1,6}(\.[0-9]{1,4})?"
    argv = ["--arch", arch, "--device", "cpu", "--smoke", "--max-new", "4",
            "--prompts", "12", "7.", "--grammar", grammar]
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert [line.split(" -> ")[0] for line in lines] == ["'12'", "'7.'"]
    dfa = compile_regex(grammar)
    for line, prompt in zip(lines, ("12", "7.")):
        text = ast.literal_eval(line.split(" -> ")[1])
        state = dfa.start
        for c in dfa.classes_of(np.frombuffer((prompt + text).encode(),
                                              np.uint8)):
            state = int(dfa.table[state, int(c)])
        assert state != dfa.sink, (prompt, text)
