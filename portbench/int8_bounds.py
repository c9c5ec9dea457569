"""The int8 GEMM's work in one served forward, from a configuration file's
``model`` and ``engine`` groups alone (not from the program's launch plan,
so that the same work is counted whatever kernel does it).

A product reads an int8 weight ``(N, K)`` with one f32 scale and one bf16
bias per output channel, reads x ``(M, K)`` and writes y ``(M, N)`` in
bf16, each once, and makes 2·M·N·K operations. Its least time is the
longer of its bytes at the HBM rate and its operations at the bf16
tensor-core peak (``portbench/bounds.py``'s rates).

The products of a forward of ``B`` rows, as the int8 engine launches them:
each Linear of both streams and the bridges (text rows padded to
``max_text_len`` + the task token, ``max_regions`` regions a row), the two
region embeddings, the two poolers, and the fused heads: the label pair's
first layer as one product over both heads' columns, its second as one
batched launch of the two heads, the pooled heads (``vil_logit`` and
``vil_tri_prediction``) as one, the grounding heads over every token, and
the NLVR2 pair's two layers at an even ``B``.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.bounds import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

# The kernels' names in a device trace (csrc/int8_linear.cu's three).
KERNEL_NAME = "int8_linear"

# One launch: its (M, N, K) parts; a batched launch has one part a batch
# entry.
Launch = Tuple[Tuple[int, int, int], ...]


def forward_products(m: dict, e: dict, B: int) -> List[Launch]:
    """The int8 launches of one forward of ``B`` rows."""
    nt, nv = B * (e["max_text_len"] + 1), B * e["max_regions"]
    h, hv, bi = m["hidden_size"], m["v_hidden_size"], m["bi_hidden_size"]
    out: List[Launch] = []

    def lin(rows, n_out, n_in):
        out.append(((rows, n_out, n_in),))

    def layer(rows, width, inter):
        for _ in range(4):  # query, key, value, attention output
            lin(rows, width, width)
        lin(rows, inter, width)
        lin(rows, width, inter)

    lin(nv, hv, m["v_feature_size"])
    lin(nv, hv, 5)
    for _ in range(m["num_hidden_layers"]):
        layer(nt, h, m["intermediate_size"])
    for _ in range(m["v_num_hidden_layers"]):
        layer(nv, hv, m["v_intermediate_size"])
    for _ in range(len(m["v_biattention_id"])):
        for _ in range(3):
            lin(nv, bi, hv)
            lin(nt, bi, h)
        lin(nv, hv, bi)
        lin(nt, h, bi)
        lin(nv, m["v_intermediate_size"], hv)
        lin(nv, hv, m["v_intermediate_size"])
        lin(nt, m["intermediate_size"], h)
        lin(nt, h, m["intermediate_size"])
    lin(B, bi, h)
    lin(B, bi, hv)
    lin(B, 2 * 2 * bi, bi)
    out.append(((B, m["num_labels"], 2 * bi),
                (B, m["gqa_num_labels"], 2 * bi)))
    lin(B, 1 + 3, bi)
    if B % 2 == 0:
        lin(B // 2, 2 * bi, 2 * bi)
        lin(B // 2, 2, 2 * bi)
    lin(nv, 1, hv)
    lin(nt, 1, h)
    return out


def launch_bytes(launch: Launch) -> int:
    return sum(n * k + 4 * n + 2 * n + 2 * mm * k + 2 * mm * n
               for mm, n, k in launch)


def launch_flops(launch: Launch) -> int:
    return sum(2 * mm * n * k for mm, n, k in launch)


def launch_bound_s(launch: Launch) -> float:
    return max(launch_bytes(launch) / PEAK_BYTES_PER_S,
               launch_flops(launch) / PEAK_BF16_FLOPS)


def forward_int8_bound(m: dict, e: dict, B: int) -> Tuple[int, float]:
    """(launches, summed least seconds) of one forward of ``B`` rows."""
    launches = forward_products(m, e, B)
    return len(launches), sum(launch_bound_s(x) for x in launches)
