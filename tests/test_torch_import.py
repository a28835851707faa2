"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU when no card exists."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
            "import repro_torch.core.engine, repro_torch.core.lvector\n"
            "import repro_torch.core.engine.baselines\n"
            "import repro_torch.core.engine.spec, repro_torch.core.profiling\n"
            "import repro_torch.kernels.onehot_match\n"
            "import repro_torch.streaming, repro_torch.streaming.ooo\n"
            "import repro_torch.streaming.blocked\n"
            "import repro_torch.core.prefilter\n"
            "import repro_torch.models, repro_torch.serving\n"
            "import repro_torch.configs, repro_torch.launch.serve\n"
            "import repro_torch.distributed, repro_torch.training\n"
            "import repro_torch.streaming.ooo.checkpoint\n"
            "import repro_torch.data, repro_torch.data.corpus\n"
            "import repro_torch.data.filter, repro_torch.data.loader\n"
            "import repro_torch.data.tokenizer\n"
            "assert 'msgpack' not in sys.modules, 'msgpack was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'the JAX package was imported'\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path}: imports {name}"


def test_matcher_without_device_needs_cuda():
    from repro_torch.core import Matcher, compile_regex

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compile_regex("ab"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compile_regex("ab"), device="cuda")


def test_ooo_stream_matcher_without_device_needs_cuda():
    from repro_torch.core import compile_regex
    from repro_torch.streaming import OooStreamMatcher

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        OooStreamMatcher([compile_regex("ab")])
    with pytest.raises(RuntimeError, match="CUDA"):
        OooStreamMatcher([compile_regex("ab")], device="cuda")
    ooo = OooStreamMatcher([compile_regex("ab")], device="cpu")
    assert ooo.matcher.device.type == "cpu" and ooo.matcher.num_chunks == 1


def test_device_tables_without_device_needs_cuda():
    from repro_torch.core import compile_regex, pack_dfas
    from repro_torch.core.engine import DeviceTables

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    packed = pack_dfas([compile_regex("ab")])
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTables.build(packed)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTables(packed, device="cuda")
    assert DeviceTables.build(packed, device="cpu").table_pad_t.device.type \
        == "cpu"


def test_matcher_unported_options_raise():
    from repro_torch.core import Matcher, compile_regex

    dfa = compile_regex("ab")
    with pytest.raises(ValueError, match="cuda"):
        Matcher(dfa, backend="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        Matcher(dfa, backend="sharded", device="cpu")
    # the autotuner is ported: a tune on the CPU, reported as the JAX
    # package reports it
    tuned = Matcher(dfa, autotune=True, device="cpu").perf_report()[
        "autotune"]
    assert set(tuned) == {"num_chunks", "mesh_shape", "l_blk",
                          "us_per_call", "source"}
    assert tuned["source"] in ("measured", "cache")
    m = Matcher(dfa, device="cpu")
    # the hot swap is ported: an equal table is a no-op, a new one swaps
    assert m.swap_patterns(dfa) is False
    assert m.swap_patterns(compile_regex("cd")) is True
    assert m.planner.table_epoch == 1


SHARDED_ONLY = [("calibrate", True), ("capacities", [1.0]), ("spec_m", 2),
                ("mesh", "mesh"), ("mesh_shape", (1, 1)), ("devices", [0])]


@pytest.mark.parametrize("backend", ["local", "cuda"])
@pytest.mark.parametrize("key,value", SHARDED_ONLY,
                         ids=[k for k, _ in SHARDED_ONLY])
def test_matcher_sharded_only_keywords_raise_as_reference(backend, key,
                                                          value):
    """A single-device Matcher refuses each sharded-only keyword with the
    JAX package's ValueError and message (its backend="local"; the port's
    "local" and "cuda" on CPU tensors)."""
    from repro.core import Matcher as JMatcher
    from repro.core import compile_regex as j_compile_regex
    from repro_torch.core import Matcher, compile_regex

    with pytest.raises(ValueError) as want:
        JMatcher(j_compile_regex("ab"), backend="local", **{key: value})
    with pytest.raises(ValueError) as got:
        Matcher(compile_regex("ab"), backend=backend, device="cpu",
                **{key: value})
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="A14"):
        Matcher(compile_regex("ab"), backend="sharded", device="cpu",
                **{key: value})


def test_serving_entry_points_without_device_need_cuda():
    from repro_torch import configs
    from repro_torch.core import compile_regex
    from repro_torch.models import api
    from repro_torch.serving import GrammarConstraint

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = configs.reduce_for_smoke(configs.get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        GrammarConstraint(compile_regex("ab"), 512)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_inputs(cfg, configs.SHAPES["train_4k"])
    gc = GrammarConstraint(compile_regex("ab"), 512, device="cpu")
    assert gc.allowed.device.type == gc.tok_cls.device.type == "cpu"
    assert api.init(cfg, 0, device="cpu")["embed"]["table"].device.type \
        == "cpu"
