"""Batched serving with deadline-bounded progressive resolution.

The JAX package's ``launch/serve.py`` in PyTorch: the paper's §IV deadline
experiment at the LM head.  Each decode step has a budget, logits are
produced resolution by resolution MSB-first, and when the budget expires
the server releases the best resolution computed so far instead of
nothing.

Two budget modes, one release contract:

* ``layer_budget`` — the budget is a *resolution count* (deterministic,
  test-friendly): the head series
  (:func:`repro_torch.core.progressive.resolution_series`) computes ``m``
  plane-partial logits on the server's device and the step releases layer
  ``budget``.
* ``deadline_ms`` — the budget is wall-clock, and the step IS a runtime
  job: the head matmul ``hidden @ W`` is submitted to a
  :class:`~repro_torch.runtime.gateway.ServingGateway` (one warm fleet per
  batch shape) with the step's deadline and a guaranteed minimum of
  resolution 0, so all deadline logic flows through the runtime's own
  machinery.  Both operands are digit-decomposed, so the step walks the
  full ``L = 2m - 1`` layered resolutions of Definition 1.  The fleet's
  workers compute on the card (``backend="cuda"``) when the server is on
  the card, and on host BLAS (``"thread"``) when it was asked for the CPU.

The server runs where its parameters are: the prefill runs the model's
kernels (flash attention, the SSD scan) there, and decode steps are
plain PyTorch there, both with autograd off.  A vlm config's prefill
takes its stub patch embeddings (``extra_embeds``), an encoder-decoder's
its stub frame embeddings (``audio_embeds``); the encoder's K/V ride in
the caches (``(caches, enc_kvs)``) through every decode step.

On the card a decode step is compiled, as the reference ``jax.jit``s its
hidden step and head series with the position traced: the server
captures one greedy step (``hidden_step`` at a position held in a device
buffer, then in the budget modes the head series and the argmax fed back
into the token buffer) in a ``torch.cuda.CUDAGraph`` and replays it once
per token.  As ``jax.jit`` compiles once per shape, the server captures
once per caches shape, batch and release: it keeps one set of caches of
each shape it has served, a decode copies the caller's caches in, replays,
and copies them back out, so every request of a shape after the first
replays only.  In ``deadline_ms`` mode only the hidden step is captured;
the head stays a runtime job.  ``graphs=False`` decodes eagerly on the
card, op by op, as the CPU always does.

While ``torch.profiler`` records, the server's calls are ranges on its
clock (``launch.graphs.span``): ``repro.serve.prefill``, and
``repro.serve.decode`` holding ``repro.serve.capture`` (when it
captures), ``repro.serve.copy_in``, one ``repro.serve.replay`` a token
(``repro.serve.step`` eagerly) and ``repro.serve.copy_out``; and the
decode replays the step's marked capture (stages ``embed``, ``mixer``,
``ffn``, ``norm``, ``head``, ``sample``) and appends its last replay's
stage times to ``launch.graphs.stage_log`` as ``serve.decode``.

    python -m repro_torch.launch.serve --arch llama3-8b --batch 4 \\
        --prompt-len 1024 --gen 16                      # on the card
    python -m repro_torch.launch.serve --arch llama3-8b-smoke \\
        --device cpu --batch 2 --prompt-len 8 --gen 4   # on the host
    python -m repro_torch.launch.serve --arch recurrentgemma-9b-smoke \\
        --device cpu                                    # hybrid, on the host
    python -m repro_torch.launch.serve --arch whisper-tiny-smoke \\
        --device cpu                                    # encoder-decoder
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import progressive
from repro_torch.kernels import flash_attention
from repro_torch.launch import graphs as graphs_lib
from repro_torch.models import transformer as T
from repro_torch.runtime import RuntimeConfig, ServingGateway
from repro_torch.tree import leaves, leaves_with_path, tree_map

__all__ = ["ProgressiveServer", "ServeStats", "main"]


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    full_resolution: int = 0
    released_at_layer: list = dataclasses.field(default_factory=list)
    #: the release scale: ``m`` head planes (layer_budget / unbudgeted
    #: mode) or ``2m - 1`` layered resolutions (deadline_ms mode)
    resolutions: int = 0
    #: measured head-service seconds per step (deadline_ms mode only)
    head_service_seconds: list = dataclasses.field(default_factory=list)


class _RuntimeHead:
    """The LM head as runtime jobs: one warm gateway per batch shape, each
    decode step one deadline-bounded layered job.

    ``hidden @ W`` is submitted as ``a.T @ b`` with ``a = hidden.T`` (so
    the coded split needs ``n1 | batch`` and ``n2 | vocab``), a per-step
    absolute deadline, and ``min_resolution=0`` — the runtime guarantees
    resolution 0 even past the deadline.
    """

    def __init__(self, w: np.ndarray, m: int, d: int, batch: int,
                 backend: str):
        vocab = w.shape[1]
        n1 = next(n for n in (4, 2, 1) if batch % n == 0)
        n2 = next(n for n in (8, 4, 2, 1) if vocab % n == 0)
        cfg = RuntimeConfig(mu=(500.0, 500.0, 500.0), arrival_rate=1000.0,
                            n1=n1, n2=n2, omega=1.0, m=m, d=d,
                            straggler="none", backend=backend)
        self.w = np.asarray(w, np.float64)
        self.num_layers = cfg.num_layers
        self.gateway = ServingGateway(cfg, admission="none").start()

    def step(self, hidden: np.ndarray,
             deadline_s: float) -> tuple[np.ndarray, int, float]:
        """One head matmul under a deadline; returns
        ``(logits, released_resolution, service_seconds)``."""
        ticket = self.gateway.submit(hidden.T, self.w,
                                     deadline=max(deadline_s, 1e-6),
                                     min_resolution=0)
        ticket.wait()
        lr = ticket.result
        rel = ticket.released_resolution
        if rel < 0:
            # the deadline fired before resolution 0 landed; the
            # guaranteed-minimum rounds still finish it
            lr.wait_resolution(0)
            rel = 0
        svc = (0.0 if lr.service_started_at is None
               or lr.released_at is None
               else lr.released_at - lr.service_started_at)
        return np.asarray(lr.resolution(rel)), rel, svc

    def close(self) -> None:
        self.gateway.stop()


class _DecodeGraph:
    """One greedy decode step (:meth:`ProgressiveServer._step`) captured in
    CUDA graphs against the server's own ``caches`` of one shape (``rec``:
    plain, and marked for the profiler, ``launch.graphs.record``).

    ``tok`` (B, 1) and ``pos`` (0-d) are the device buffers the step reads
    and updates in place; ``out`` is the static output of the graph that
    replayed last (the hidden state without a ``release``, else the
    released logits), overwritten by every :meth:`replay`.  ``caches``
    are the server's own for this shape: the warm-up before the capture
    (cuBLAS handles and workspaces, on a side stream) runs on them, and
    each decode copies its caches in first.
    """

    def __init__(self, server: "ProgressiveServer", caches, batch: int,
                 release: Optional[int]):
        dev = server.device
        self.caches = caches
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        # the warm-up steps copies of tok and pos: the capture starts
        # from the buffers as they are
        with torch.no_grad():
            rec = graphs_lib.record(
                lambda: server._step(self.tok, self.pos, caches, release),
                dev, warm=lambda: server._step(
                    self.tok.clone(), self.pos.clone(), caches, release))
        self.rec, self.out = rec, rec.out
        self.pool_bytes, self.capture_seconds = (rec.pool_bytes,
                                                 rec.capture_seconds)

    def start(self, tokens: torch.Tensor, pos: int) -> None:
        """Load the first token (B, 1) and its position."""
        self.tok.copy_(tokens)
        self.pos.fill_(pos)

    def replay(self) -> None:
        self.out = self.rec.replay()


def _shape_key(caches) -> tuple:
    """What a captured step baked in of a caches object: every tensor's
    place in the tree, shape and type."""
    return tuple((path, tuple(t.shape), t.dtype)
                 for path, t in leaves_with_path(caches))


def _copy_into(dst, src) -> None:
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def _cache_len(cfg: ModelConfig, caches) -> Optional[int]:
    """The positions the attention caches hold (their length), or None
    where no layer has one (a ring of the last W positions or a
    recurrent state takes any position)."""
    if cfg.is_encdec:
        caches = caches[0]
    lens = [c["k"].shape[2]
            for (unit, _), group in zip(T.block_groups(cfg), caches)
            for kind, c in zip(unit, group)
            if kind in ("dense", "moe", "cross", "attn_moe")]
    return min(lens, default=None)


class ProgressiveServer:
    """Greedy batched decoding with a layered LM head.

    ``device`` is where the server runs, the card unless the caller asks
    for the CPU; ``params`` must already live there (``models.convert`` or
    ``init_params(..., device=...)`` put them there).

    ``graphs`` (default: on for a card server) decodes through CUDA graphs
    (the module docstring); ``graphs=False`` decodes eagerly; the CPU has
    no graphs, so ``graphs=True`` there raises.  A capture or replay that
    fails raises: nothing falls back to eager.  The server holds one set
    of caches and its captured steps per caches shape until
    :meth:`close`.  ``graph_log`` records each capture's batch, release,
    seconds and private-pool bytes.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, m: int = 2,
                 d: int = 7, device: str | torch.device = "cuda",
                 graphs: Optional[bool] = None):
        dev = resolve_device(device)
        pdev = params["embed"].device
        if pdev.type != dev.type:
            raise ValueError(f"parameters are on {pdev}, the server was "
                             f"asked for {dev}")
        if graphs is None:
            graphs = pdev.type == "cuda"
        if graphs and pdev.type != "cuda":
            raise ValueError(f"graphs=True needs a card server; this one "
                             f"is on {pdev}")
        self.graphs = graphs
        self.graph_log: list[dict] = []
        self._graphs: dict[tuple, _DecodeGraph] = {}
        self._graph_caches: dict[tuple, object] = {}
        self.cfg = cfg
        self.params = params
        self.device = pdev
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(torch.float32)
        if cfg.logits_scaling != 1.0:
            # a power of two in Granite's case, so the planes are the
            # unscaled weight's and only their scale moves
            w = w / cfg.logits_scaling
        self.lm_head = progressive.make_layered_linear(w, m=m, d=d)
        self._head_w = w
        self.m = m
        self.d = d
        self._backend = "cuda" if pdev.type == "cuda" else "thread"
        self._runtime_heads: dict[int, _RuntimeHead] = {}

    def _runtime_head(self, batch: int) -> _RuntimeHead:
        head = self._runtime_heads.get(batch)
        if head is None:
            head = _RuntimeHead(self._head_w.cpu().numpy(), self.m, self.d,
                                batch, self._backend)
            self._runtime_heads[batch] = head
        return head

    def close(self) -> None:
        """Stop every runtime-head gateway fleet and drop the captured
        decode steps with their caches (idempotent)."""
        self._graphs, self._graph_caches = {}, {}
        heads, self._runtime_heads = self._runtime_heads, {}
        for head in heads.values():
            head.close()

    def __enter__(self) -> "ProgressiveServer":
        return self

    def __exit__(self, *exc) -> None:
        del exc
        self.close()

    def prefill(self, tokens: torch.Tensor, max_len: int, **extras):
        """(last logits, caches) of the prompt; ``extras`` are the
        model's ``extra_embeds`` / ``audio_embeds``.  Raises
        ``flash_attention.KernelFault`` if a kernel of the prefill
        reported a fault of its own."""
        with graphs_lib.span("repro.serve.prefill"):
            extras = {k: v.to(self.device) for k, v in extras.items()}
            with torch.no_grad():
                out = T.prefill(self.params, tokens.to(self.device),
                                self.cfg, max_len=max_len, **extras)
            # synchronizes only after a launch of a kernel that reports
            # faults (the dh-256 flash kernel)
            flash_attention.check_faults()
        return out

    def head_series(self, hidden: torch.Tensor) -> torch.Tensor:
        """All ``m`` weight-only head resolutions of ``hidden`` (B, D)."""
        return progressive.resolution_series(self.lm_head,
                                             hidden.to(torch.float32))

    def _step(self, tok: torch.Tensor, pos: torch.Tensor, caches,
              release: Optional[int]) -> torch.Tensor:
        """One greedy decode step on device buffers, as the server captures
        it: ``hidden_step`` of ``tok`` (B, 1) at ``pos`` (0-d int64) with
        the caches written in place, then ``pos`` advanced by one.  With a
        ``release`` (1..m) the head series follows and the argmax of that
        resolution is written into ``tok``; returns those logits, else
        the hidden state (B, D) for a runtime head."""
        hidden, _ = T.hidden_step(self.params, tok, caches, pos, self.cfg)
        pos.add_(1)
        if release is None:
            return hidden
        logits = self.head_series(hidden)[release - 1]
        graphs_lib.mark("head")
        tok.copy_(torch.argmax(logits, dim=-1)[:, None])
        graphs_lib.mark("sample")
        return logits

    def _graph(self, caches, batch: int,
               release: Optional[int]) -> _DecodeGraph:
        """The captured step for caches of ``caches``' shape, this batch
        and release, captured now if it is not yet (on the server's caches
        of that shape, made now if need be)."""
        shape = _shape_key(caches)
        graph = self._graphs.get((shape, batch, release))
        if graph is None:
            own = self._graph_caches.get(shape)
            if own is None:
                own = tree_map(torch.zeros_like, caches)
            with graphs_lib.span("repro.serve.capture"):
                graph = _DecodeGraph(self, own, batch, release)
            self._graph_caches[shape] = own
            self._graphs[(shape, batch, release)] = graph
            self.graph_log.append({"batch": batch, "release": release,
                                   "capture_seconds": graph.capture_seconds,
                                   "pool_bytes": graph.pool_bytes})
        return graph

    def decode(self, tokens: torch.Tensor, caches, start_pos: int,
               num_tokens: int, *, layer_budget: Optional[int] = None,
               deadline_ms: Optional[float] = None):
        """Greedy decode; each step releases logits at the resolution the
        budget allows.  Returns (tokens (B, num_tokens), stats).

        With ``deadline_ms``, ``stats.released_at_layer`` counts layered
        resolutions (1..2m-1: the runtime decomposes BOTH operands);
        otherwise head planes (1..m).  ``stats.resolutions`` carries the
        scale in use.  ``caches`` are updated in place.  Raises
        ``ValueError`` before any step if the last position would not fit
        the attention caches.
        """
        if layer_budget is not None and deadline_ms is not None:
            raise ValueError(
                "layer_budget and deadline_ms are mutually exclusive "
                "budgets; pass one or the other")
        limit = _cache_len(self.cfg, caches)
        if limit is not None and start_pos + num_tokens > limit:
            raise ValueError(f"{num_tokens} tokens from position "
                             f"{start_pos} overrun caches of {limit} "
                             f"positions")
        stats = ServeStats(resolutions=(2 * self.m - 1
                                        if deadline_ms is not None
                                        else self.m))
        budget = (None if deadline_ms is not None
                  else self.m if layer_budget is None
                  else max(1, min(layer_budget, self.m)))
        span = graphs_lib.span
        with span("repro.serve.decode"):
            tok = tokens.to(self.device)
            graph = None
            if self.graphs:
                graph = self._graph(caches, tok.shape[0], budget)
                with span("repro.serve.copy_in"):
                    _copy_into(graph.caches, caches)
                    graph.start(tok, start_pos)
            step_span = ("repro.serve.step" if graph is None
                         else "repro.serve.replay")
            out = []
            for i in range(num_tokens):
                with span(step_span):
                    tok, release = self._next(graph, tok, caches,
                                              start_pos + i, budget,
                                              deadline_ms, stats)
                stats.steps += 1
                stats.full_resolution += int(release == stats.resolutions)
                stats.released_at_layer.append(release)
                out.append(tok)
            if graph is not None:
                with span("repro.serve.copy_out"):
                    _copy_into(caches, graph.caches)
                graph.rec.log_stages("serve.decode")
        return torch.cat(out, dim=1), stats

    def _next(self, graph: Optional[_DecodeGraph], tok: torch.Tensor,
              caches, pos: int, budget: Optional[int],
              deadline_ms: Optional[float], stats: ServeStats):
        """One decode step of :meth:`decode` (a replay of ``graph``, or
        eagerly without one); returns (the next token (B, 1), the
        release)."""
        if graph is not None:
            graph.replay()
            hidden = graph.out  # the released logits, given a budget
        else:
            with torch.no_grad():
                hidden, _ = T.hidden_step(self.params, tok, caches, pos,
                                          self.cfg)
        if deadline_ms is not None:
            head = self._runtime_head(int(hidden.shape[0]))
            logits_np, rel, svc = head.step(
                hidden.to(torch.float64).cpu().numpy(), deadline_ms / 1e3)
            stats.head_service_seconds.append(svc)
            tok = torch.argmax(torch.from_numpy(logits_np),
                               dim=-1)[:, None].to(self.device)
            if graph is not None:
                graph.tok.copy_(tok)
            return tok, rel + 1
        if graph is not None:
            return graph.tok.clone(), budget    # the graph wrote the argmax
        logits = self.head_series(hidden)[budget - 1]
        return torch.argmax(logits, dim=-1)[:, None], budget


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Greedy serving with a layered LM head.")
    ap.add_argument("--arch", default="llama3-8b-smoke",
                    help=f"one of {sorted(registry.ARCH_IDS)} or "
                         f"{sorted(registry.PORT_ARCH_IDS)}, at its "
                         f"published widths, or with '-smoke' appended "
                         f"its smoke config")
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--layer-budget", type=int, default=None,
                    help="resolutions computable per step (None = all)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="wall-clock budget per decode step; the head "
                         "runs as a deadline-bounded runtime job")
    ap.add_argument("--planes", type=int, default=2)
    args = ap.parse_args(argv)

    if args.arch.endswith("-smoke"):
        cfg = registry.get_smoke_config(args.arch[: -len("-smoke")])
    else:
        cfg = registry.get_config(args.arch)
    params = T.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (args.batch, args.prompt_len)))
    max_len = args.prompt_len + args.gen
    with ProgressiveServer(cfg, params, m=args.planes,
                           device=args.device) as server:
        _, caches = server.prefill(tokens, max_len,
                                   **T.stub_extras(cfg, args.batch,
                                                   server.device))
        out, stats = server.decode(tokens[:, -1:], caches, args.prompt_len,
                                   args.gen, layer_budget=args.layer_budget,
                                   deadline_ms=args.deadline_ms)
    print(f"[serve] generated {tuple(out.shape)} tokens on {server.device}; "
          f"{stats.full_resolution}/{stats.steps} steps at full resolution "
          f"(of {stats.resolutions}); "
          f"release layers: {stats.released_at_layer}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
