#!/usr/bin/env python3
"""Write ``wgmma.cuh``: the warpgroup products the Hopper kernels issue.

    python3 src/repro_torch/kernels/csrc/gen_wgmma.py

A ``wgmma.mma_async`` names every accumulator register in its operand
list (N / 2 of them for an m64nN tile), so each width is its own inline
PTX statement.  This script writes them out:

- ``WgmmaSS<N>::mma``: D[64, N] (+)= A[64, 16] B[16, N], A and B both
  K-major in shared memory, through their descriptors (B9's Q K^T);
- ``WgmmaRS<N>::mma<TRANS_B>``: the same with A in registers (four
  32-bit registers of bf16 pairs, the m64k16 fragment) and B in shared
  memory, K-major (``TRANS_B`` 0) or MN-major (1) (B9's P V, B8's
  products).

bf16 operands, float32 accumulate; ``scale_d`` 0 overwrites D, 1 adds.
"""

from __future__ import annotations

import pathlib

SS_WIDTHS = (128,)                      # B9's S = Q K^T over 128 kv rows
RS_WIDTHS = tuple(range(16, 257, 16))   # B9's D, B8's Q_pad
HEADER = pathlib.Path(__file__).with_name("wgmma.cuh")


def _regs(n_out: int) -> tuple[str, str]:
    names = ", ".join(f"%{i}" for i in range(n_out))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n_out))
    return names, outs


def _ss(n: int) -> str:
    r = n // 2
    names, outs = _regs(r)
    return f"""template <>
struct WgmmaSS<{n}> {{
    static __device__ __forceinline__ void mma(float (&d)[{r}], uint64_t da,
                                               uint64_t db, int scale_d) {{
        asm volatile(
            "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
            "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
            "{{{names}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
            : {outs}
            : "l"(da), "l"(db), "r"(scale_d));
    }}
}};
"""


def _rs(n: int) -> str:
    r = n // 2
    names, outs = _regs(r)
    return f"""template <>
struct WgmmaRS<{n}> {{
    template <int TRANS_B>
    static __device__ __forceinline__ void mma(float (&d)[{r}], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t db,
                                               int scale_d) {{
        asm volatile(
            "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
            "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
            "{{{names}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, "
            "p, 1, 1, %{r + 6};\\n}}\\n"
            : {outs}
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
              "n"(TRANS_B));
    }}
}};
"""


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py in this directory; do not edit.\n"
        "//\n"
        "// Hopper warpgroup products (sm_90a), bf16 x bf16 -> float32, for\n"
        "// an m64nNk16 tile: WgmmaSS<N> reads A and B (both K-major) from\n"
        "// shared memory through their descriptors, WgmmaRS<N> takes A from\n"
        "// registers (the m64k16 bf16 fragment) and B from shared memory,\n"
        "// K-major (TRANS_B 0) or MN-major (1).  scale_d 0 overwrites D.\n"
        "// Issue between wgmma_fence() and wgmma_commit(); D and A must not\n"
        "// be touched until wgmma_wait<0>() returns.\n\n"
        "#pragma once\n\n#include <stdint.h>\n\n"
        "namespace wg {\n\n"
        "__device__ __forceinline__ void wgmma_fence() {\n"
        '    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");\n}\n\n'
        "__device__ __forceinline__ void wgmma_commit() {\n"
        '    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: '
        '"memory");\n}\n\n'
        "template <int N>\n__device__ __forceinline__ void wgmma_wait() {\n"
        '    asm volatile("wgmma.wait_group.sync.aligned %0;\\n" :: "n"(N) '
        ': "memory");\n}\n\n'
        "// keep the compiler from moving reads or writes of v across a wgmma\n"
        "// fence, commit or wait: every register a wgmma reads or writes must\n"
        "// be final before its stage's wgmma_fence(), or the compiler\n"
        "// serializes the stage\n"
        "template <int R>\n"
        "__device__ __forceinline__ void fence_regs(float (&v)[R]) {\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < R; ++i)\n"
        '        asm volatile("" : "+f"(v[i])::"memory");\n}\n\n'
        "template <int R>\n"
        "__device__ __forceinline__ void fence_regs(uint32_t (&v)[R]) {\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < R; ++i)\n"
        '        asm volatile("" : "+r"(v[i])::"memory");\n}\n\n'
        "template <int N>\nstruct WgmmaSS;\n\ntemplate <int N>\n"
        "struct WgmmaRS;\n\n"]
    parts += [_ss(n) + "\n" for n in SS_WIDTHS]
    parts += [_rs(n) + "\n" for n in RS_WIDTHS]
    parts.append("}  // namespace wg\n")
    return "".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
