"""The work a step of a hybrid with experts in every layer needs (IBM
Granite 4.0-H: Mamba2 and attention mixers, each layer ending in a
dropless expert layer with a shared expert), counted as ``costs.py``
counts the ``dense`` and ``ssm`` families, with its peaks and helpers.

Work counts what the configuration needs: the mixers', router's and
shared expert's weights once at bfloat16, and of the held experts those
that a step's pairs touch.  In a decode step of ``B`` tokens with top
``k`` of ``router_width`` experts under uniform routing, a held expert is
touched with probability ``1 - (1 - k / router_width)^B`` and the held
experts get ``B k num_experts / router_width`` pairs; a prefill touches
every held expert.  The kernel's own bound (``experts_bound_s``) reads
what the port's routing counter saw instead.  Times are in seconds.
"""

from __future__ import annotations

from perfbench import costs

__all__ = ["layer_counts", "decode_step_work", "prefill_work",
           "decode_bound_s", "serve_batch_bound_s", "experts_bound_s",
           "route_counts"]


def _dims(model: dict) -> dict:
    s, a, m = model["ssm"], model["attention"], model["moe"]
    D = model["d_model"]
    d_in = s["expand"] * D
    return {"D": D, "V": model["vocab_size"], "d_in": d_in,
            "N": s["d_state"], "P": s["head_dim"], "Hs": d_in // s["head_dim"],
            "K": s["d_conv"], "H": a["num_heads"], "kv": a["num_kv_heads"],
            "dh": a["head_dim"], "E": m["num_experts"],
            "Er": m["num_router_experts"] or m["num_experts"],
            "k": m["top_k"], "F": m["d_ff_expert"], "Fs": m["d_ff_shared"]}


def layer_counts(model: dict) -> dict:
    """Elements of each part's weights: a Mamba2 mixer's matrices
    (``mamba``) and other parameters (``mamba_small``), an attention
    mixer's (``attn``), the router, one expert, the shared expert, and
    the two norms of a layer; and the count of each mixer."""
    d = _dims(model)
    D, d_in, N, Hs, K = d["D"], d["d_in"], d["N"], d["Hs"], d["K"]
    kinds = model["layer_types"]
    return {"mamba": D * (2 * d_in + 2 * N + Hs) + d_in * D,
            "mamba_small": (K + 1) * (d_in + 2 * N) + 3 * Hs + d_in,
            "attn": 2 * D * d["H"] * d["dh"] + 2 * D * d["kv"] * d["dh"],
            "router": D * d["Er"], "expert": 3 * D * d["F"],
            "shared": 3 * D * d["Fs"], "norms": 2 * D,
            "n_mamba": kinds.count("mamba"),
            "n_attn": kinds.count("attention")}


def _common_weights(c: dict, L: int) -> int:
    """Elements every token reads: mixers, routers, shared experts, norms
    (the experts apart)."""
    return (c["n_mamba"] * (c["mamba"] + c["mamba_small"])
            + c["n_attn"] * c["attn"]
            + L * (c["router"] + c["shared"] + c["norms"]))


def _state_bytes(model: dict, B: int, positions: int) -> float:
    """The Mamba2 layers' recurrent state (fp32) and conv windows (bf16),
    and the attention layers' K and V over ``positions`` at bf16."""
    d, c = _dims(model), layer_counts(model)
    ssm = c["n_mamba"] * B * (4.0 * d["Hs"] * d["P"] * d["N"] + 2.0 * (
        d["K"] - 1) * (d["d_in"] + 2 * d["N"]))
    kv = 2.0 * 2 * c["n_attn"] * B * positions * d["kv"] * d["dh"]
    return ssm + kv


def _held_pairs(d: dict, tokens: int) -> float:
    return tokens * d["k"] * d["E"] / d["Er"]


def decode_step_work(model: dict, B: int, ctx: int, release: int) -> dict:
    """Work of one greedy decode step of ``B`` sequences whose new token
    attends ``ctx`` positions: the matmuls (the held pairs' experts), the
    attention over the cache and the state update, ``release`` int8 head
    planes; weights at bfloat16 (the held experts the step touches), the
    planes at a byte an entry, the state read and written and the cache
    read once, the logits written in fp32."""
    d, c = _dims(model), layer_counts(model)
    L, D, V = model["num_layers"], d["D"], d["V"]
    touched = d["E"] * (1.0 - (1.0 - d["k"] / d["Er"]) ** B)
    flops = (2.0 * B * (c["n_mamba"] * c["mamba"] + c["n_attn"] * c["attn"]
                        + L * (c["router"] + c["shared"]))
             + 2.0 * L * _held_pairs(d, B) * c["expert"]
             + 4.0 * c["n_attn"] * B * d["H"] * d["dh"] * ctx
             + c["n_mamba"] * B * (2.0 * d["K"] * (d["d_in"] + 2 * d["N"])
                                   + 6.0 * d["Hs"] * d["P"] * d["N"]))
    ssm_state = 2.0 * (_state_bytes(model, B, 0))
    kv = _state_bytes(model, B, ctx) - _state_bytes(model, B, 0)
    nbytes = (2.0 * (_common_weights(c, L) + L * touched * c["expert"] + D)
              + 1.0 * release * D * V + 2.0 * B * D + ssm_state + kv
              + 4.0 * B * V)
    return {"flops": flops, "int8_ops": 2.0 * B * D * V * release,
            "bytes": nbytes}


def prefill_work(model: dict, B: int, S: int) -> dict:
    """Flops and bytes a prefill of ``B`` prompts of ``S`` needs: the
    matmuls over every position (the held pairs' experts), attention and
    scans, the plain head at the last position only; every weight once at
    bfloat16 (all held experts), the head once, the prompts' embedding
    rows, the caches and states written once, the last logits in fp32."""
    d, c = _dims(model), layer_counts(model)
    L, D, V = model["num_layers"], d["D"], d["V"]
    chunk = min(model["ssm"]["chunk_size"], S)
    nc = -(-S // chunk)
    flops = (2.0 * B * S * (c["n_mamba"] * c["mamba"]
                            + c["n_attn"] * c["attn"]
                            + L * (c["router"] + c["shared"]))
             + 2.0 * L * _held_pairs(d, B * S) * c["expert"]
             + c["n_attn"] * costs.flash_flops(B, S, S, d["H"], d["dh"],
                                               True, None)
             + c["n_mamba"] * (costs.ssd_flops(B, nc, chunk, d["Hs"], d["P"],
                                               d["N"])
                               + 2.0 * d["K"] * (d["d_in"] + 2 * d["N"])
                               * B * S)
             + 2.0 * B * D * V)
    nbytes = (2.0 * (_common_weights(c, L) + L * d["E"] * c["expert"] + D)
              + 2.0 * D * V + 2.0 * B * S * D + _state_bytes(model, B, S)
              + 4.0 * B * V)
    return {"flops": flops, "int8_ops": 0.0, "bytes": nbytes}


def decode_bound_s(model: dict, B: int, S: int, steps: int,
                   release: int) -> float:
    """Bound of ``steps`` decode steps after a prompt of ``S``."""
    return sum(costs.bound_s(decode_step_work(model, B, S + i + 1, release))
               for i in range(steps))


def serve_batch_bound_s(model: dict, B: int, S: int, G: int,
                        release: int) -> float:
    """Bound of one request batch: its prefill, then ``G`` decode steps."""
    return (costs.bound_s(prefill_work(model, B, S))
            + decode_bound_s(model, B, S, G, release))


def experts_bound_s(model: dict, route: list) -> float:
    """Bound of the grouped products of one step, from the routing
    counter's ``[touched held experts, held pairs]`` of each layer: per
    layer the touched experts' three matrices once at bf16 and each pair's
    rows in and out of both products (D + F each way), or ``6 D F`` flops
    a pair at the bf16 peak, whichever takes longer; summed over the
    layers."""
    d = _dims(model)
    D, F = d["D"], d["F"]
    total = 0.0
    for touched, pairs in route:
        nbytes = 2.0 * (touched * 3 * D * F + 2 * pairs * (D + F))
        flops = 6.0 * pairs * D * F
        total += max(nbytes / costs.PEAK_BYTES,
                     flops / costs.PEAK_BF16_FLOPS)
    return total


def route_counts(step: str):
    """The routing counter of the newest ``step`` entry of the port's
    counter log (``[touched, pairs]`` a layer), or None where the port
    keeps none."""
    from repro_torch.launch import graphs
    entries = [e for e in getattr(graphs, "counter_log", ())
               if e["step"] == step]
    if not entries:
        return None
    return entries[-1]["counters"].get("moe.route")
