"""The port's analysis tools (``repro_torch.launch.{roofline,census,dryrun}``)
against the JAX package's ``launch.{roofline,hlo_census,dryrun}``.

Parity is held on the pure functions and on arithmetic: the reference's own
dry run does not compile every cell on this jax, and its census reads
useful ~0.00 where it does.  The fake worlds run in subprocesses, so this
process never holds one; the top level imports only numpy, torch and
pytest, and the JAX package is imported inside the tests.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "granite-moe-1b-a400m", "internlm2-20b",
         "internvl2-2b", "llama3-8b", "phi3.5-moe-42b-a6.6b",
         "recurrentgemma-2b", "seamless-m4t-medium", "tinyllama-1.1b",
         "xlstm-1.3b")


def _run(code: str, timeout: int = 120) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


# -- roofline ------------------------------------------------------------------

COLLECTIVES = [
    {"all-gather": {"bytes": 100.0, "group_sizes": [4]},
     "all-reduce": {"bytes": 100.0, "group_sizes": [4]},
     "reduce-scatter": {"bytes": 100.0, "group_sizes": [4]},
     "all-to-all": {"bytes": 0.0, "group_sizes": []},
     "collective-permute": {"bytes": 100.0, "group_sizes": [2]}},
    {"all-gather": {"bytes": 5.5e9, "group_sizes": [16, 256]},
     "all-reduce": {"bytes": 3.0e3, "group_sizes": [1]},
     "all-to-all": {"bytes": 7.0e8, "group_sizes": [16]},
     "reduce-scatter": {"bytes": 2.5e8, "group_sizes": []}},
    {},
]


def test_wire_bytes_and_tokens_of_match_the_reference():
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline

    for coll in COLLECTIVES:
        assert roofline.wire_bytes(coll) == ref.wire_bytes(coll)
    assert roofline.wire_bytes(COLLECTIVES[0]) == pytest.approx(
        100 * 3 / 4 + 2 * 100 * 3 / 4 + 100 * 3 + 100)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert roofline.tokens_of(name) == ref.tokens_of(name)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    from repro.launch import roofline as ref

    from repro_torch.configs import list_archs
    from repro_torch.launch import roofline

    assert arch in list_archs()
    assert roofline.count_params(arch) == ref.count_params(arch)


def test_count_params_moe_active_figures():
    from repro_torch.launch import roofline

    assert roofline.count_params("phi3.5-moe-42b-a6.6b") == (
        41_874_100_224, 6_641_946_624)


def test_analyze_record_under_reference_constants(monkeypatch):
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline

    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(ref, name))
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "single",
           "ok": True, "n_devices": 256,
           "census": {"dot_flops": 8.54e15, "approx_hbm_bytes": 3.1e12},
           "collectives": COLLECTIVES[1], "memory": {"temp_bytes": 12345}}
    n = ref.count_params("tinyllama-1.1b")
    got, want = roofline.analyze_record(rec, n), ref.analyze_record(rec, n)
    assert set(got) == set(want)
    for key in want:
        if key != "suggestion":
            assert got[key] == want[key], key
    assert "NVLink" in roofline.analyze_record(
        dict(rec, census={"dot_flops": 1.0}), n)["suggestion"]


def test_h100_constants():
    from repro_torch.launch import roofline

    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)
    assert roofline.ARTIFACTS.rstrip(os.sep).endswith("dryrun_torch")


# -- census --------------------------------------------------------------------

def _nested_steps(w, x):
    for _ in range(3):
        for _ in range(4):
            x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("kind", ["real", "fake", "fake-cuda"])
def test_census_counts_nested_loop_trips(kind):
    """The torch program of the reference's
    ``test_census_counts_while_trip_multipliers``: 3 x 4 nested steps."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.census import trace_census

    d = 32
    if kind == "real":
        out, c = trace_census(_nested_steps, torch.eye(d),
                              torch.ones(8, d))
        assert out.shape == (8, d)
    else:
        dev = "cuda" if kind == "fake-cuda" else "cpu"
        with FakeTensorMode():
            _, c = trace_census(_nested_steps,
                                torch.empty(d, d, device=dev),
                                torch.empty(8, d, device=dev))
    assert c["dot_flops"] == 2 * 8 * d * d * 3 * 4
    assert c["max_multiplier"] == 12
    assert c["ops"] == {"aten.mm.default": 12, "aten.tanh.default": 12}
    # each product reads x and w and writes x; each tanh reads and writes x
    assert c["approx_hbm_bytes"] == 12 * 4 * (8 * d + d * d + 8 * d
                                              + 2 * 8 * d)
    assert c["kernels"] == {} and c["n_ops"] == 24


def test_census_charges_views_nothing_and_in_place_ops_their_operands():
    from repro_torch.launch.census import trace_census

    def prog(x):
        y = x.view(-1)[:10].t()             # views
        x.add_(1.0)                         # in place: x, its one operand
        return y.clone()                    # 10 read, 10 written

    _, c = trace_census(prog, torch.zeros(4, 8))
    assert c["bytes_by_op"] == {"aten.add_": 4 * 32.0,
                                "aten.clone": 4 * 20.0}
    assert c["dot_flops"] == 0 and c["max_multiplier"] == 1


def test_train_step_census_equal_on_real_and_fake_tensors():
    """A reduced tinyllama train step (full remat, 2 microbatches) on the
    CPU: the census of a real step equals the dry run's fake trace."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.census import trace_census
    from repro_torch.models import api
    from repro_torch.training import (TrainOptions, init_train_state,
                                      make_train_step)

    cfg = dataclasses.replace(reduce_for_smoke(get_config("tinyllama-1.1b")),
                              remat_policy="nothing")
    shape = ShapeSpec("train_64", "train", 64, 4)
    opts = TrainOptions(num_microbatches=2)
    state = init_train_state(cfg, 0, device="cpu")
    batch = api.make_inputs(cfg, shape, 0, device="cpu")
    (_, metrics), real = trace_census(make_train_step(cfg, None, opts),
                                      state, batch)
    assert np.isfinite(float(metrics["loss"]))
    fake = dryrun.trace_one_card(cfg, shape, opts=opts, device="cpu")
    assert fake["census"] == {k: v for k, v in real.items()
                              if k != "collectives"}
    assert fake["collectives"] == real["collectives"]
    # one product signature repeats at least once a layer and microbatch
    assert real["dot_flops"] > 0 and real["max_multiplier"] >= 2 * 2
    mem = fake["memory"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"] > 0


def test_flash_attn_census_routes():
    """Real CPU tensors take B9's plain version under a census; fake ones
    inside ``fake_card`` take the wrapper's fake path (no launch); any other
    kernel refuses FakeTensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attn, ops, token_mask
    from repro_torch.launch.census import fake_card, trace_census

    g = torch.Generator().manual_seed(0)
    bh, t, d = 4, 40, 16
    q, k, v = (torch.randn(bh, t, d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = dict(flash_attn.launches)
    out, c = trace_census(ops.flash_attn, q, k, v)
    assert torch.equal(out, flash_attn.flash_attn_torch(q, k, v))
    assert c["kernels"] == {} and c["dot_flops"] > 0
    with fake_card():
        out, c = trace_census(ops.flash_attn, q, k, v)
        with pytest.raises(ValueError):
            flash_attn.flash_attn_cuda(q, k, v)
    assert torch.equal(out, flash_attn.flash_attn_torch(q, k, v))
    assert c["kernels"] == {}
    with FakeTensorMode(), fake_card():
        fq, fk, fv = (torch.empty(bh, t, d, dtype=torch.bfloat16)
                      for _ in range(3))
        out, c = trace_census(ops.flash_attn, fq, fk, fv, window=8)
        assert out.shape == (bh, t, d) and out.dtype == torch.bfloat16
        pairs = sum(min(i + 1, 8) for i in range(t))
        assert c["kernels"] == {"flash_attn": {
            "launches": 1, "flops": 4.0 * d * bh * pairs,
            "bytes": 2.0 * d * 4 * bh * t}}
        assert c["dot_flops"] == 0
        with pytest.raises(ValueError, match="token_mask"):
            ops.token_mask(torch.zeros(2, dtype=torch.int32),
                           torch.ones(3, 64, dtype=torch.uint8),
                           torch.empty(2, 64))
    assert flash_attn.launches == before


def test_fake_kernel_calls_outside_a_census_record_nothing():
    """Outside a census the card route counts nothing: B9's fake path
    still launches nothing and returns its output's shape, and any other
    kernel still refuses FakeTensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import census_hooks, flash_attn, ops

    before = dict(flash_attn.launches)
    assert not census_hooks.active()
    with FakeTensorMode(), census_hooks.fake_card():
        q = torch.empty(4, 40, 16, dtype=torch.bfloat16)
        out = ops.flash_attn(q, q, q)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="token_mask"):
            ops.token_mask(torch.zeros(2, dtype=torch.int32),
                           torch.ones(3, 64, dtype=torch.uint8),
                           torch.empty(2, 64))
    assert flash_attn.launches == before and not census_hooks.active()


@pytest.mark.parametrize("package", ["kernels", "models"])
def test_routing_layers_do_not_import_the_analysis_tools(package):
    """The kernels and the model decide their route through
    ``kernels.census_hooks``, never by importing ``launch.census``,
    ``launch.dryrun`` or ``launch.roofline``."""
    import ast

    tools = ("census", "dryrun", "roofline")

    base = os.path.join(ROOT, "src", "repro_torch", package)
    for name in sorted(os.listdir(base)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(base, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = (node.module or "").split(".")
                names = {a.name for a in node.names}
                if "launch" in mod:
                    tail = mod[mod.index("launch") + 1:]
                    assert not set(tail) & set(tools) \
                        and not (not tail and names & set(tools)), \
                        (name, node.module, names)


# -- the fake world and the dry run --------------------------------------------

def test_fake_world_sum_over_data_mesh_shows_its_all_reduce():
    out = _run("""
        import json, torch, torch.distributed as dist
        from repro_torch.launch import dryrun, mesh as lmesh
        from repro_torch.launch.census import trace_census
        dryrun.fake_world(8)
        mesh = lmesh.make_mesh((8,), ("data",), device="cpu")
        assert mesh.transport == "fake"
        x = torch.ones(64, 4)
        total, c = trace_census(
            lambda x: lmesh.all_reduce(x.sum(0), mesh, "data"), x)
        dist.destroy_process_group()
        print(json.dumps(c["collectives"]))
    """)
    coll = json.loads(out.strip().splitlines()[-1])
    assert coll["all-reduce"] == {"bytes": 16.0, "count": 1,
                                  "static_count": 1, "group_sizes": [8]}
    assert all(coll[k]["count"] == 0 for k in coll if k != "all-reduce")


def test_dryrun_train_cell_keeps_the_logits_vocab_parallel(tmp_path):
    """tinyllama-1.1b train_4k on the (16, 16) fake world cut to 256
    tokens, one microbatch of the rank's 16 rows: the step's temporaries
    hold less than two float32 copies of the rank's whole-vocab logits
    (16 x 256 x 32,000), since the loss reduces each rank's 1/16 of the
    vocab over "model"; the dot flops are the cut cell's."""
    _run(f"""
        import dataclasses, os, sys
        os.environ["REPRO_NM"] = "1"
        from repro_torch.configs import SHAPES
        from repro_torch.launch import dryrun
        SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"],
                                                 seq_len=256)
        sys.argv = ["dryrun", "--arch", "tinyllama-1.1b", "--shape",
                    "train_4k", "--mesh", "single", "--out",
                    {str(tmp_path)!r}]
        sys.exit(dryrun.main())
    """, timeout=300)
    with open(tmp_path / "single" / "tinyllama-1.1b--train_4k.json") as f:
        rec = json.load(f)
    assert rec["ok"], rec.get("error")
    assert rec["num_microbatches"] == 1
    whole = 16 * 256 * 32_000 * 4
    assert rec["memory"]["temp_bytes"] < 2 * whole
    # forward, recompute and backward products of 16 x 256 tokens a rank
    # over 1/16 of the MLP, heads and vocab
    assert 0 < rec["census"]["dot_flops"] < 4.11e13 * 256 / 4096


def test_dryrun_prefill_cell_on_the_card_route(tmp_path):
    """One cell of the CLI in a subprocess: tinyllama-1.1b prefill_32k on
    the (16, 16) fake world, the card's program (B9 counted, not run)."""
    _run(f"""
        import sys
        from repro_torch.launch import dryrun
        sys.argv = ["dryrun", "--arch", "tinyllama-1.1b", "--shape",
                    "prefill_32k", "--mesh", "single", "--out",
                    {str(tmp_path)!r}]
        sys.exit(dryrun.main())
    """, timeout=300)
    with open(tmp_path / "single" / "tinyllama-1.1b--prefill_32k.json") as f:
        rec = json.load(f)
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == 256 and rec["route"] == "cuda"
    assert rec["memory"]["temp_bytes"] > 0
    # the hand count of rank 0's share: its 32 / 16 rows over "data", 32 /
    # 16 query heads and the 1 of 4 kv heads they read, 5,632 / 16 MLP
    # columns and 32,000 / 16 vocab columns over "model"; per layer the q,
    # k, v and o projections and the three MLP products over its 2 x
    # 32,768 tokens, then the head on the last position only
    b, t, d, h, kv, hd, ff, n_layers, vocab = (2, 32_768, 2048, 2, 1, 64,
                                               352, 22, 2_000)
    per_token = 2 * d * (2 * h * hd + 2 * kv * hd + 3 * ff)
    assert rec["census"]["dot_flops"] == n_layers * b * t * per_token \
        + 2 * b * d * vocab
    b9 = rec["census"]["kernels"]["flash_attn"]
    assert b9["launches"] == n_layers
    assert b9["flops"] == n_layers * 4 * hd * b * h * t * (t + 1) / 2
    # a layer: its 7 leaves over "data", wk and wv (split on head_dim) over
    # "model"; the table, the head, the logits over "model", their rows
    # over "data"; two sums over "model" a layer and the embedding's
    assert rec["collectives"]["all-gather"]["count"] == 9 * n_layers + 4
    assert rec["collectives"]["all-reduce"]["count"] == 2 * n_layers + 1

    from repro_torch.launch import roofline
    row, = roofline.analyze_all(str(tmp_path))
    assert row["ok"] and row["dominant"] in ("compute", "memory")
    assert row["hlo_flops_chip"] == rec["census"]["dot_flops"] + b9["flops"]
    assert "tinyllama-1.1b | prefill_32k | single" in roofline.to_markdown(
        [row])
