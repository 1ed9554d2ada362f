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
from repro_torch.models import transformer as T
from repro_torch.runtime import RuntimeConfig, ServingGateway

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


class ProgressiveServer:
    """Greedy batched decoding with a layered LM head.

    ``device`` is where the server runs, the card unless the caller asks
    for the CPU; ``params`` must already live there (``models.convert`` or
    ``init_params(..., device=...)`` put them there).
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, m: int = 2,
                 d: int = 7, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        pdev = params["embed"].device
        if pdev.type != dev.type:
            raise ValueError(f"parameters are on {pdev}, the server was "
                             f"asked for {dev}")
        self.cfg = cfg
        self.params = params
        self.device = pdev
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(torch.float32)
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
        """Stop every runtime-head gateway fleet (idempotent)."""
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
        extras = {k: v.to(self.device) for k, v in extras.items()}
        with torch.no_grad():
            out = T.prefill(self.params, tokens.to(self.device), self.cfg,
                            max_len=max_len, **extras)
        # synchronizes only after a launch of a kernel that reports
        # faults (the dh-256 flash kernel)
        flash_attention.check_faults()
        return out

    def head_series(self, hidden: torch.Tensor) -> torch.Tensor:
        """All ``m`` weight-only head resolutions of ``hidden`` (B, D)."""
        return progressive.resolution_series(self.lm_head,
                                             hidden.to(torch.float32))

    def decode(self, tokens: torch.Tensor, caches, start_pos: int,
               num_tokens: int, *, layer_budget: Optional[int] = None,
               deadline_ms: Optional[float] = None):
        """Greedy decode; each step releases logits at the resolution the
        budget allows.  Returns (tokens (B, num_tokens), stats).

        With ``deadline_ms``, ``stats.released_at_layer`` counts layered
        resolutions (1..2m-1: the runtime decomposes BOTH operands);
        otherwise head planes (1..m).  ``stats.resolutions`` carries the
        scale in use.  ``caches`` are updated in place.
        """
        if layer_budget is not None and deadline_ms is not None:
            raise ValueError(
                "layer_budget and deadline_ms are mutually exclusive "
                "budgets; pass one or the other")
        stats = ServeStats(resolutions=(2 * self.m - 1
                                        if deadline_ms is not None
                                        else self.m))
        tok = tokens.to(self.device)
        out = []
        for i in range(num_tokens):
            with torch.no_grad():
                hidden, caches = T.hidden_step(self.params, tok, caches,
                                               start_pos + i, self.cfg)
            if deadline_ms is not None:
                head = self._runtime_head(int(hidden.shape[0]))
                logits_np, rel, svc = head.step(
                    hidden.to(torch.float64).cpu().numpy(),
                    deadline_ms / 1e3)
                release = rel + 1
                stats.head_service_seconds.append(svc)
                logits = torch.from_numpy(logits_np)
            else:
                release = (self.m if layer_budget is None
                           else max(1, min(layer_budget, self.m)))
                logits = self.head_series(hidden)[release - 1]
            stats.steps += 1
            stats.full_resolution += int(release == stats.resolutions)
            stats.released_at_layer.append(release)
            tok = torch.argmax(logits, dim=-1)[:, None].to(self.device)
            out.append(tok)
        return torch.cat(out, dim=1), stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Greedy serving with a layered LM head.")
    ap.add_argument("--arch", default="llama3-8b-smoke",
                    help=f"one of {sorted(registry.ARCH_IDS)}, at its "
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
