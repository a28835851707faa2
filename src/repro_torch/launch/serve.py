"""Serving driver: batched generation with optional grammar constraints.

On the card (the default device):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --prompts "12" "7." --grammar "[0-9]{1,6}(\\.[0-9]{1,4})?"

On the CPU, at the reduced smoke width:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --prompts "12" "7." --grammar "[0-9]{1,6}(\\.[0-9]{1,4})?"

Streaming endpoint path (``--stream``): prompts are treated as chunked
uploads — each request's bytes are fed to the grammar's resumable cursors in
``--chunk-bytes`` pieces (``GrammarConstraint.open_decode``), so the DFA
prefill happens incrementally as chunks arrive.  The pre-fed
``DecodeStream`` is then handed to ``ServingEngine.generate``.  With
``--snapshot-dir`` every chunk round atomically publishes the prefill
cursors (``StreamMatcher.snapshot``, one ``step_<N>`` a round) — the
failover point a fresh process resumes from with ``StreamMatcher.restore``
(in this package or the JAX one).  The weights are random, made from
``--seed`` on the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --stream --chunk-bytes 2 --snapshot-dir snap --prompts "3.14" \\
      --grammar "[0-9]{1,6}(\\.[0-9]{1,4})?"
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config, reduce_for_smoke
from ..core import compile_regex
from ..models import api
from ..serving import GrammarConstraint, ServeConfig, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompts", nargs="+", default=["hello"])
    ap.add_argument("--grammar", default=None,
                    help="regex constraining generated bytes")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="feed prompts as chunked uploads through the "
                         "streaming grammar cursors (requires --grammar)")
    ap.add_argument("--chunk-bytes", type=int, default=4,
                    help="upload chunk size for --stream")
    ap.add_argument("--snapshot-dir", default=None,
                    help="with --stream: atomically snapshot the prefill "
                         "cursors after every chunk round (failover point; "
                         "StreamMatcher.restore resumes from the latest "
                         "published step, on either backend or device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.stream and not args.grammar:
        ap.error("--stream requires --grammar (it streams the DFA prefill)")
    if args.snapshot_dir and not args.stream:
        ap.error("--snapshot-dir requires --stream (it checkpoints the "
                 "streaming prefill cursors)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = api.init(cfg, args.seed, device=args.device)

    constraint = None
    if args.grammar:
        constraint = GrammarConstraint(compile_regex(args.grammar),
                                       cfg.padded_vocab, device=args.device)

    eng = ServingEngine(cfg, params,
                        ServeConfig(max_new_tokens=args.max_new,
                                    temperature=args.temperature),
                        constraint=constraint)
    width = max(len(p) for p in args.prompts)
    prompts = np.full((len(args.prompts), width), 32, np.int32)  # pad w/ space
    for i, p in enumerate(args.prompts):
        enc = np.frombuffer(p.encode()[:width], np.uint8)
        prompts[i, : len(enc)] = enc

    decode_stream = None
    if args.stream:
        # simulate the streaming endpoint: every request's prompt bytes land
        # chunk by chunk; each chunk advances the resumable cursors (one
        # coalesced tick per arrival round across the whole batch)
        decode_stream = constraint.open_decode(len(args.prompts))
        width_chunks = -(-prompts.shape[1] // args.chunk_bytes)
        for c in range(width_chunks):
            decode_stream.feed_tokens(
                prompts[:, c * args.chunk_bytes:(c + 1) * args.chunk_bytes])
            if args.snapshot_dir:
                path = decode_stream.stream.snapshot(args.snapshot_dir)
                print(f"[stream] snapshot round {c}: {path}")
        st = decode_stream.stream.stats
        print(f"[stream] prefill: {st.feeds} chunk feeds -> {st.ticks} ticks "
              f"({st.segments} segments, occupancy {st.occupancy:.2f})")

    out = eng.generate(prompts, seed=args.seed, decode_stream=decode_stream)
    for prompt, row in zip(args.prompts, out):
        text = bytes(int(t) for t in row if t < 256).decode(errors="replace")
        print(f"{prompt!r} -> {text!r}")


if __name__ == "__main__":
    main()
