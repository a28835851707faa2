"""Roofline analysis over dry-run records, on NVIDIA H100 SXM constants.

The port of the JAX package's ``launch/roofline.py``, with one card of an
H100 SXM in place of a TPU chip:

  PEAK_FLOPS = 989.4e12  dense bf16 tensor-core flops/s
  HBM_BW     = 3.35e12   HBM3 bytes/s
  LINK_BW    = 450e9     NVLink 4 bytes/s one GPU sends in one direction:
                         half of the 900 GB/s total that NVIDIA's H100
                         datasheet gives for an SXM card's 18 links

A record's census is one rank's (``launch.census``; the JAX package's
``hlo_census`` records read the same), so the three terms are directly

  t_compute    = (dot_flops + kernel flops) / PEAK_FLOPS
  t_memory     = approx_hbm_bytes / HBM_BW
  t_collective = sum_k wire_bytes_k / LINK_BW, ring factors per kind:
                   all-gather         out * (n-1)/n
                   all-reduce         2 * out * (n-1)/n
                   reduce-scatter     out * (n-1)        (out is the shard)
                   all-to-all         out * (n-1)/n
                   collective-permute out

Kernel flops are the ``kernels`` key of a port record: the work of the
hand-written kernels, which the dispatcher does not see as products.
MODEL_FLOPS = f * N * D per rank (f = 6 train, 2 prefill/decode; N = active
parameters for MoE) gives the useful-compute ratio MODEL_FLOPS / census
flops, which catches remat and repeated work.  Roofline fraction =
t_compute / max(all three terms).

Usage:  python -m repro_torch.launch.roofline [--artifacts DIR] [--csv]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "ARTIFACTS", "count_params",
           "wire_bytes", "tokens_of", "analyze_record", "analyze_all",
           "to_markdown", "main"]

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 450e9

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _leaves(tree, path=()):
    """(path, shape) of every leaf, keys sorted at each level (the order in
    which the JAX package flattens the same tree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def count_params(arch: str) -> tuple[float, float]:
    """(total, active) parameter counts from the initialisers' shapes
    (``models.api.param_shapes``: the meta device, no draws).  An expert
    leaf counts ``top_k / n_experts`` of itself as active."""
    from ..configs import get_config
    from ..models import api

    cfg = get_config(arch)
    total = active = 0.0
    for names, shape in _leaves(api.param_shapes(cfg)):
        n = math.prod(shape)
        total += n
        if "moe" in names and any(s in names[-1] for s in _EXPERT_LEAVES):
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        else:
            active += n
    return total, active


def wire_bytes(collectives: dict) -> float:
    """Bytes one rank puts on its links for a census's collectives (ring
    costs; the group's size is the largest recorded)."""
    total = 0.0
    for kind, rec in collectives.items():
        b = float(rec.get("bytes", 0))
        gss = rec.get("group_sizes") or []
        n = max(gss) if gss else 2
        if n <= 1:
            continue
        if kind == "all-gather":
            total += b * (n - 1) / n
        elif kind == "all-reduce":
            total += 2 * b * (n - 1) / n
        elif kind == "reduce-scatter":
            total += b * (n - 1)
        elif kind == "all-to-all":
            total += b * (n - 1) / n
        else:  # collective-permute
            total += b
    return total


def tokens_of(shape_name: str) -> tuple[float, float]:
    """(tokens per step, model-flops factor) for a shape."""
    from ..configs import SHAPES
    s = SHAPES[shape_name]
    if s.kind == "train":
        return s.seq_len * s.global_batch, 6.0
    if s.kind == "prefill":
        return s.seq_len * s.global_batch, 2.0
    return 1.0 * s.global_batch, 2.0  # decode: one token per sequence


def analyze_record(rec: dict, n_params: tuple[float, float]) -> dict:
    """One record's roofline row."""
    census = rec.get("census", {})
    kernel_flops = sum(float(k.get("flops", 0.0))
                       for k in census.get("kernels", {}).values())
    flops = float(census.get("dot_flops", 0.0)) + kernel_flops
    hbm = float(census.get("approx_hbm_bytes", 0.0))
    coll = wire_bytes(rec.get("collectives", {}))
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_l = coll / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    dominant = max(terms, key=terms.get)
    total, active = n_params
    toks, factor = tokens_of(rec["shape"])
    chips = rec.get("n_devices", 1)
    model_flops_chip = factor * active * toks / max(chips, 1)
    ratio = model_flops_chip / flops if flops else 0.0
    bound = max(terms.values()) or 1e-12
    frac = t_c / bound
    mfu_proxy = model_flops_chip / (PEAK_FLOPS * bound) if bound else 0.0
    suggest = {
        "compute": "compute-bound: cut repeated flops (tensor parallelism "
                   "along 'model', remat policy, causal block skipping) or "
                   "accept - this is the roofline",
        "memory": "HBM-bound: raise arithmetic intensity (fused kernels, "
                  "more rows per rank, bf16 master grads, cache layout)",
        "collective": "NVLink-bound: cut NCCL volume (fewer ZeRO gathers, "
                      "bucketed exchanges, 2-tier pod-local reduce, overlap "
                      "with compute)",
    }[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "ok": rec.get("ok", False),
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_l,
        "dominant": dominant,
        "hlo_flops_chip": flops,
        "model_flops_chip": model_flops_chip,
        "useful_ratio": ratio,
        "roofline_fraction": frac,
        "mfu_proxy": mfu_proxy,
        "temp_bytes": rec.get("memory", {}).get("temp_bytes"),
        "suggestion": suggest,
    }


def analyze_all(artifacts: str = ARTIFACTS) -> list[dict]:
    """The rows of every ``<mesh>/<arch>--<shape>.json`` under
    ``artifacts`` (either package's records)."""
    params_cache: dict[str, tuple[float, float]] = {}
    out = []
    for path in sorted(glob.glob(os.path.join(artifacts, "*", "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            out.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                        "mesh": rec.get("mesh"), "ok": False,
                        "error": rec.get("error", "")[:160]})
            continue
        arch = rec["arch"]
        if arch not in params_cache:
            params_cache[arch] = count_params(arch)
        out.append(analyze_record(rec, params_cache[arch]))
    return out


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "bound | useful | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - "
                         f"| - | FAILED | - | - |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s'] * 1e3:.2f} | {r['t_memory_s'] * 1e3:.2f} "
            f"| {r['t_collective_s'] * 1e3:.2f} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return hdr + "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=ARTIFACTS)
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    rows = analyze_all(args.artifacts)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.csv:
        print("arch,shape,mesh,t_compute_s,t_memory_s,t_collective_s,"
              "dominant,useful_ratio,roofline_fraction")
        for r in rows:
            if r.get("ok"):
                print(f"{r['arch']},{r['shape']},{r['mesh']},"
                      f"{r['t_compute_s']:.6g},{r['t_memory_s']:.6g},"
                      f"{r['t_collective_s']:.6g},{r['dominant']},"
                      f"{r['useful_ratio']:.4f},{r['roofline_fraction']:.4f}")
    else:
        print(to_markdown(rows))


if __name__ == "__main__":
    main()
