"""The serve driver: a closed loop of whole request batches through the
port's ``ProgressiveServer``, then the sample that decides ``correct``.

A batch is ``batch`` prompts of ``prompt`` tokens drawn from the seed.
The caller sends it when the previous batch has returned:
``server.prefill``; the greedy token of its last logits fed to
``server.decode`` for one step (the first released token), then for the
other ``gen - 1``, each call ending in a synchronize.  The window runs
whole batches until ``seconds`` have passed.  Set-up draws the weights,
builds the server (its head planes) and warms up the cell's shapes: one
prefill and the decode graph's capture at its batch, prompt and release.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import devtrace
from perfbench.model import derive_seed
from perfbench.reference.common import (Precision, argmax_gaps, gaps,
                                        no_tf32, released_weight)

__all__ = ["run", "check", "sample_requests"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _marked_kernels(calls: dict):
    """Wrap the port's kernel entry points (``kernels.ops.flash_attention``,
    ``ssd_scan_fused``) from outside in ``bench.flash_attention`` and
    ``bench.ssd_scan`` ranges, recording each call's shapes in ``calls``."""
    from repro_torch.kernels import ops
    real_fa, real_ssd = ops.flash_attention, ops.ssd_scan_fused

    def flash_attention(q, k, v, *, causal=True, window=None):
        B, Sq, H, dh = q.shape
        calls.setdefault("flash_attention", []).append(
            {"B": B, "Sq": Sq, "Skv": k.shape[1], "H": H, "kv": k.shape[2],
             "dh": dh, "causal": causal, "window": window,
             "elem": q.element_size()})
        with devtrace.span("flash_attention"):
            return real_fa(q, k, v, causal=causal, window=window)

    def ssd_scan_fused(x, dt, A, Bm, Cm, *, chunk=256, init_state=None):
        B, S, H, P = x.shape
        calls.setdefault("ssd_scan", []).append(
            {"B": B, "nc": S // chunk, "l": chunk, "H": H, "P": P,
             "N": Bm.shape[-1]})
        with devtrace.span("ssd_scan"):
            return real_ssd(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)

    ops.flash_attention, ops.ssd_scan_fused = flash_attention, ssd_scan_fused
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan_fused = real_fa, real_ssd


class _Batches:
    """Prompt batches drawn from the seed on the device, one generator per
    purpose (warm-up, window, trace), so the window's draws do not depend
    on what set-up drew."""

    def __init__(self, seed: int, purpose: str, B: int, S: int, V: int,
                 device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive_seed(seed, "traffic", purpose))
        self.shape, self.V, self.device = (B, S), V, device

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.V, self.shape, generator=self.gen,
                             device=self.device)


def _serve_batch(server, prompts, traffic: dict, sync):
    """One request batch; returns (tokens (B, 1 + gen), times)."""
    S, G = traffic["prompt"], traffic["gen"]
    budget = traffic["layer_budget"]
    t0 = time.perf_counter()
    logits, caches = server.prefill(prompts, S + G)
    first = torch.argmax(logits, dim=-1)[:, None]
    sync()
    t1 = time.perf_counter()
    one, _ = server.decode(first, caches, S, 1, layer_budget=budget)
    sync()
    t2 = time.perf_counter()
    rest, _ = server.decode(one, caches, S + 1, G - 1, layer_budget=budget)
    sync()
    t3 = time.perf_counter()
    times = {"prefill_s": t1 - t0, "first_s": t2 - t1, "rest_s": t3 - t2,
             "ttft_s": t2 - t0, "decode_s": t3 - t1, "batch_s": t3 - t0}
    return torch.cat([first, one, rest], dim=1), times


def _head_ms(server, B: int, D: int, device, reps: int = 20) -> float:
    """CUDA-event ms of ``server.head_series`` on a hidden of the cell's
    batch (mean over ``reps`` back-to-back calls, after three)."""
    hidden = torch.randn((B, D), dtype=torch.float32, device=device)
    for _ in range(3):
        server.head_series(hidden)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        server.head_series(hidden)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(ctx: dict) -> dict:
    """Set up, warm up, run the window (and with ``ctx["trace"]`` the
    traced stretch) of a serve cell.  Returns the run's record: the
    per-batch times, the window, set-up seconds, the served tokens and
    prompts, the memory peak and, traced, the head time and the trace."""
    from repro_torch.launch.serve import ProgressiveServer
    cfg, traffic, device = ctx["cfg"], ctx["traffic"], ctx["device"]
    B, S, G = traffic["batch"], traffic["prompt"], traffic["gen"]
    V = cfg.vocab_size
    sync = lambda: _sync(device)
    head = ctx["head"]
    server = ProgressiveServer(cfg, ctx["params"], m=head["m"], d=head["d"],
                               device=device)
    ctx["log"]("server built (head planes)")
    try:
        warm = _Batches(ctx["seed"], "warm-up", B, S, V, device).next()
        logits, caches = server.prefill(warm, S + G)
        first = torch.argmax(logits, dim=-1)[:, None]
        server.decode(first, caches, S, 2, layer_budget=traffic["layer_budget"])
        sync()
        del logits, caches, first, warm
        captures = len(server.graph_log)
        traffic_gen = _Batches(ctx["seed"], "window", B, S, V, device)
        batches, prompts, outputs = [], [], []
        setup_s = time.perf_counter() - ctx["t_start"]
        ctx["log"]("warmed up: one prefill, the decode graph captured")
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < ctx["seconds"]:
            p = traffic_gen.next()
            out, times = _serve_batch(server, p, traffic, sync)
            batches.append(times)
            prompts.append(p)
            outputs.append(out)
        window_s = time.perf_counter() - w0
        ctx["log"](f"window closed: {len(batches)} batches")
        rec = {"kind": "serve", "setup_s": setup_s, "window_s": window_s,
               "batches": batches, "prompts": prompts, "outputs": outputs,
               "requests": B * len(batches),
               "graph_captures": len(server.graph_log) - captures,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                     if torch.device(device).type == "cuda"
                                     else 0)}
        if ctx["trace"]:
            rec["head_ms"] = _head_ms(server, B, cfg.d_model, device)
            calls: dict = {}
            tp = _Batches(ctx["seed"], "trace", B, S, V, device).next()
            k = traffic["trace_decode_steps"]

            def stretch():
                with _marked_kernels(calls):
                    with devtrace.span("prefill"):
                        logits, caches = server.prefill(tp, S + G)
                        first = torch.argmax(logits, dim=-1)[:, None]
                        sync()
                with devtrace.span("decode"):
                    server.decode(first, caches, S, k,
                                  layer_budget=traffic["layer_budget"])
                    sync()

            rec["trace"] = devtrace.traced(stretch, ctx["tmpdir"])
            rec["trace"]["decode_steps"] = k
            rec["calls"] = calls
            ctx["log"]("traced stretch read")
    finally:
        server.close()
    return rec


def sample_requests(seed: int, requests: int, n: int) -> list[int]:
    """The requests (indices in window order) whose tokens are checked:
    ``n`` drawn from the seed, the last one always among them."""
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    n = min(n, requests)
    rest = rng.choice(requests - 1, size=n - 1, replace=False) if n > 1 \
        else []
    return sorted({requests - 1, *map(int, rest)})


def _request(rec: dict, i: int, B: int):
    return rec["prompts"][i // B][i % B], rec["outputs"][i // B][i % B]


def check(rec: dict, ctx: dict, *, control: bool = False) -> dict:
    """Run the plain reference over the sampled requests' prompts and
    served tokens.  Returns ``{"token_gap": ...}``: the widest gap by which
    a served token's reference logit lies below the reference's best, over
    the token the prefill's head chose (the plain head at the last prompt
    position) and the tokens the layered head released (the head at the
    released resolution).  With ``control`` the same is read of the tokens
    that the fp8 reference puts first instead."""
    traffic, model, head = ctx["traffic"], ctx["model"], ctx["head"]
    ref = ctx["reference"]
    B, S, G = traffic["batch"], traffic["prompt"], traffic["gen"]
    release = traffic["layer_budget"] or head["m"]
    params = ctx["params"]
    fp32, fp8 = Precision("fp32"), Precision("fp8")
    no_tf32()
    worst = 0.0
    with torch.no_grad():
        w = ref.head_weight(params, model).to(torch.float32)
        w_rel = released_weight(w, head["m"], head["d"], release)
        for i in sample_requests(ctx["seed"], rec["requests"],
                                 traffic["sample_requests"]):
            prompt, out = _request(rec, i, B)
            seq = torch.cat([prompt, out[:G]])
            h = ref.hidden(params, seq, model, fp32)
            plain = h[S - 1:S] @ w
            layered = h[S:S + G] @ w_rel
            if control:
                h8 = ref.hidden(params, seq, model, fp8)
                g = torch.cat([argmax_gaps(plain, fp8.mm(h8[S - 1:S], w)),
                               argmax_gaps(layered,
                                           fp8.mm(h8[S:S + G], w_rel))])
            else:
                g = torch.cat([gaps(plain, out[:1]), gaps(layered, out[1:])])
            worst = max(worst, g.max().item())
    return {"token_gap": worst}
