"""The yardstick's arithmetic: the card's peaks, roofline bounds, and the
work that a step of a configuration needs.

``roofline``, ``flash_bound`` and ``ssd_bound`` are frozen copies of
``chip_smoke.py``'s helpers of the same names, and ``flash_flops`` and
``ssd_flops`` of the port's ``kernels.flash_attention.flops`` and
``kernels.ssd_scan.flops``, so a change to the port cannot move them.

Work counts what the configuration needs, not what the program does:
weight matrices read once at the bfloat16 compute width, the head's int8
planes only up to the released resolution, the prefill's head at the
last prompt position only, caches and recurrent state read and written
once, and the flops of the matmuls, attention and scans.  Norms, rotary
embeddings and activations are left out (a lower bound stays a lower
bound).  Times are in seconds unless a name says ms.
"""

from __future__ import annotations

import functools

__all__ = ["PEAK_BF16_FLOPS", "PEAK_INT8_OPS", "PEAK_FP32_FLOPS",
           "PEAK_BYTES", "roofline", "flash_flops", "flash_bound",
           "ssd_flops", "ssd_bound", "layer_weights", "num_params",
           "prefill_work", "decode_step_work", "bound_s", "decode_bound_s",
           "serve_batch_bound_s", "train_step_work", "share_pct"]

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12      # tensor cores
PEAK_FP32_FLOPS = 67e12       # CUDA cores (no TF32: fp32 work stays fp32)
PEAK_BYTES = 3.35e12


def roofline(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) for ``flops`` at ``peak`` and ``nbytes`` at the
    memory rate, and which of the two sets it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def flash_flops(B: int, Sq: int, Skv: int, H: int, dh: int, causal: bool,
                window) -> float:
    """Floating-point operations of one attention call: ``4 dh`` (q k^T
    and p v) per (query, key) pair that the mask keeps, query ``i`` and
    key ``j`` at positions ``i`` and ``j``, for each of the ``B H`` (batch,
    head) pairs."""
    pairs = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    return 4.0 * dh * pairs * B * H


def flash_bound(B, Sq, Skv, H, kv, dh, causal, window, elem, peak):
    """Bound (ms, by) of one attention call: 4*dh flops per unmasked
    (query, key) pair (q k^T and p v), q, k, v read once and o written
    once."""
    flops = flash_flops(B, Sq, Skv, H, dh, causal, window)
    nbytes = elem * dh * (2 * B * Sq * H + 2 * B * Skv * kv)
    return roofline(flops, nbytes, peak)


def ssd_flops(B: int, nc: int, l: int, H: int, P: int, N: int) -> float:
    """Floating-point operations of one scan of ``nc`` chunks of ``l``
    with one B/C group: per (batch, chunk) the scores C B^T once for all
    heads on the ``l (l + 1) / 2`` pairs i >= j (2 N each); per (batch,
    head, chunk) the masked scores times dt x on those pairs (2 P each),
    C state^T and the state update (2 l N P each)."""
    pairs = l * (l + 1) // 2
    return (2.0 * pairs * N * B * nc
            + (2.0 * pairs * P + 4.0 * l * N * P) * B * H * nc)


def ssd_bound(B, nc, l, H, P, N, peak):
    """Bound (ms, by) of one SSD scan (one B/C group, x/B/C in bf16, dt
    in fp32) at ``peak``: each input read once, y and the final state
    written once in fp32."""
    flops = ssd_flops(B, nc, l, H, P, N)
    S = nc * l
    nbytes = (2 * B * S * H * P + 4 * B * S * H + 4 * H + 2 * 2 * B * S * N
              + 4 * B * S * H * P + 4 * B * H * P * N)
    return roofline(flops, nbytes, peak)


# ---------------------------------------------------------------------------
# Work of a configuration's steps
# ---------------------------------------------------------------------------

def _ssm_dims(model: dict) -> tuple[int, int, int, int, int]:
    s = model["ssm"]
    d_in = s["expand"] * model["d_model"]
    return d_in, s["d_state"], s["head_dim"], d_in // s["head_dim"], \
        s["d_conv"]


def layer_weights(model: dict) -> int:
    """Elements of one layer's weight matrices (what its matmuls read)."""
    D = model["d_model"]
    if model["family"] == "dense":
        a = model["attention"]
        H, kv, dh = a["num_heads"], a["num_kv_heads"], a["head_dim"]
        return 2 * D * H * dh + 2 * D * kv * dh + 3 * D * model["d_ff"]
    if model["family"] == "ssm":
        d_in, N, _, H, _ = _ssm_dims(model)
        return D * (2 * d_in + 2 * N + H) + d_in * D
    raise ValueError(f"no work count for family {model['family']!r}")


def _layer_small(model: dict) -> int:
    """Elements of one layer's other parameters (norms, taps, biases)."""
    D = model["d_model"]
    if model["family"] == "dense":
        return 2 * D
    d_in, N, _, H, K = _ssm_dims(model)
    return (K + 1) * (d_in + 2 * N) + 3 * H + d_in + D


def num_params(model: dict) -> int:
    V, D = model["vocab_size"], model["d_model"]
    heads = 1 if model["tie_embeddings"] else 2
    return (model["num_layers"] * (layer_weights(model) + _layer_small(model))
            + heads * V * D + D)


def _body_bytes(model: dict) -> float:
    """Every layer's parameters once at the bfloat16 width."""
    return 2.0 * model["num_layers"] * (layer_weights(model)
                                        + _layer_small(model))


def _mixer_flops(model: dict, B: int, S: int) -> float:
    """Attention or scan flops of all layers over a causal prompt of
    ``S``, and the convolutions."""
    L = model["num_layers"]
    if model["family"] == "dense":
        a = model["attention"]
        return L * flash_flops(B, S, S, a["num_heads"], a["head_dim"],
                               a["causal"], a["window"])
    d_in, N, P, H, K = _ssm_dims(model)
    chunk = min(model["ssm"]["chunk_size"], S)
    nc = -(-S // chunk)
    return L * (ssd_flops(B, nc, chunk, H, P, N)
                + 2.0 * K * (d_in + 2 * N) * B * S)


def _state_bytes(model: dict, B: int, positions: int) -> float:
    """Bytes of every layer's cache over ``positions`` positions (an
    attention layer's K and V at bfloat16), or its recurrent state (fp32)
    and convolution window (bfloat16)."""
    L = model["num_layers"]
    if model["family"] == "dense":
        a = model["attention"]
        return 2.0 * 2 * L * B * positions * a["num_kv_heads"] * a["head_dim"]
    d_in, N, P, H, K = _ssm_dims(model)
    return L * B * (4.0 * H * P * N + 2.0 * (K - 1) * (d_in + 2 * N))


def prefill_work(model: dict, B: int, S: int) -> dict:
    """Flops and bytes a prefill of ``B`` prompts of ``S`` needs: the
    body's matmuls over every position, attention or scans, the plain head
    at the last position only; the body's weights and the head once at
    bfloat16, the prompts' embedding rows, the caches or states written
    once, the last logits written in fp32."""
    D, V = model["d_model"], model["vocab_size"]
    flops = (2.0 * B * S * model["num_layers"] * layer_weights(model)
             + _mixer_flops(model, B, S) + 2.0 * B * D * V)
    nbytes = (_body_bytes(model) + 2.0 * D * V + 2.0 * B * S * D
              + _state_bytes(model, B, S) + 4.0 * B * V)
    return {"flops": flops, "int8_ops": 0.0, "bytes": nbytes}


def decode_step_work(model: dict, B: int, ctx: int, release: int) -> dict:
    """Work of one greedy decode step of ``B`` sequences whose new token
    attends ``ctx`` positions (itself included): the body's matmuls, the
    attention over the cache or the state update, ``release`` int8 head
    planes; the body's weights at bfloat16, the planes at a byte an entry,
    the cache read once (the state read and written once), the logits
    written in fp32."""
    D, V, L = model["d_model"], model["vocab_size"], model["num_layers"]
    flops = 2.0 * B * L * layer_weights(model)
    if model["family"] == "dense":
        a = model["attention"]
        flops += 4.0 * L * B * a["num_heads"] * a["head_dim"] * ctx
        state = _state_bytes(model, B, ctx)
    else:
        d_in, N, P, H, K = _ssm_dims(model)
        flops += L * B * (2.0 * K * (d_in + 2 * N) + 6.0 * H * P * N)
        state = 2.0 * _state_bytes(model, B, 1)
    int8_ops = 2.0 * B * D * V * release
    nbytes = (_body_bytes(model) + 1.0 * release * D * V + 2.0 * B * D
              + state + 4.0 * B * V)
    return {"flops": flops, "int8_ops": int8_ops, "bytes": nbytes}


def bound_s(work: dict) -> float:
    """Least seconds for ``work`` on one H100: its operations at their
    peaks or its bytes at the memory rate, whichever takes longer."""
    t_ops = (work["flops"] / PEAK_BF16_FLOPS
             + work["int8_ops"] / PEAK_INT8_OPS)
    return max(t_ops, work["bytes"] / PEAK_BYTES)


def decode_bound_s(model: dict, B: int, S: int, steps: int,
                   release: int) -> float:
    """Bound of ``steps`` decode steps after a prompt of ``S``: the step
    at position ``S + i`` attends ``S + i + 1`` positions."""
    return sum(bound_s(decode_step_work(model, B, S + i + 1, release))
               for i in range(steps))


def serve_batch_bound_s(model: dict, B: int, S: int, G: int,
                        release: int) -> float:
    """Bound of one request batch: its prefill, then ``G`` decode steps."""
    return (bound_s(prefill_work(model, B, S))
            + decode_bound_s(model, B, S, G, release))


def train_step_work(model: dict, B: int, S: int) -> dict:
    """Work of one training step on ``B`` rows of ``S``: three times the
    forward's flops (forward, and backward's two products each), the head
    over every position; the parameters read and written in fp32, and the
    gradient and AdamW's two moments each written and read once (24 bytes
    a parameter)."""
    D, V = model["d_model"], model["vocab_size"]
    fwd = (2.0 * B * S * (model["num_layers"] * layer_weights(model) + D * V)
           + _mixer_flops(model, B, S))
    return {"flops": 3.0 * fwd, "int8_ops": 0.0,
            "bytes": 24.0 * num_params(model) + 8.0 * B * S}


def share_pct(bound: float, seconds: float) -> float:
    """``bound`` as a percentage of the ``seconds`` measured."""
    return 100.0 * bound / seconds

