"""The port's tracing: stage marks inside captured steps, the stage log and
the host spans on ``torch.profiler``'s clock (``launch.graphs``).

The CPU tests hold the gate (nothing is entered or read while the
profiler is off), the spans' names and nesting in the server's prefill
and eager decode and in an eager train step, and the arithmetic of a
read.  The card tests (marker ``cuda``) hold a decode captured with its
marks to the eager tokens and each graph's stage sum to a CUDA-event
pair around its replay.  Nothing here imports JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_tracing.py
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.serve import ProgressiveServer  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

_B, _S, _G = 2, 16, 3


@pytest.fixture(autouse=True)
def empty_stage_log():
    graphs.stage_log.clear()
    yield
    graphs.stage_log.clear()


def _serve(arch, dev="cpu", **server_kw):
    """prefill and decode of ``arch``'s smoke config; returns the
    server, the prompt and the decoded tokens."""
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device=dev)
    server = ProgressiveServer(cfg, params, device=dev, **server_kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (_B, _S), generator=gen,
                           device=dev)
    _, caches = server.prefill(prompt, _S + _G,
                               **T.stub_extras(cfg, _B, dev, seed=2))
    out, _ = server.decode(prompt[:, -1:], caches, _S, _G)
    return server, prompt, out


def _train_step(arch, dev="cpu", graphed=False, num_layers=None, batch=2,
                seq=16):
    """One train step of ``arch``'s smoke config (or, given
    ``num_layers``, its full config cut to that depth); returns the step
    (graphed or eager) and its arguments."""
    cfg = (registry.get_smoke_config(arch) if num_layers is None else
           dataclasses.replace(registry.get_config(arch),
                               num_layers=num_layers))
    step, optimizer = steps_lib.make_train_step(cfg, TrainConfig())
    if graphed:
        step = steps_lib.graph_step(step, "train")
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    full = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev)
    batch = {"tokens": full[:, :-1], "targets": full[:, 1:]}
    return step, (params, optimizer.init(params), batch)


def _ranges(prof) -> list:
    """The profiler's ``repro.*`` ranges: (name, start, end, parent's
    name among them or None)."""
    out = []
    for e in prof.events():
        if not e.name.startswith("repro."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("repro."):
            parent = parent.cpu_parent
        out.append((e.name, e.time_range.start, e.time_range.end,
                    None if parent is None else parent.name))
    return sorted(out, key=lambda r: r[1])


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------

def test_mark_outside_a_capture_does_nothing(monkeypatch):
    """A mark outside a capture by ``graphs.record`` makes no event and
    reads nothing, on the CPU as in an eager call."""
    def no_event(*a, **k):
        raise AssertionError("a mark made an event outside a capture")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert graphs._open_marks is None
    assert graphs.mark("mixer") is None
    _serve("llama3-8b")                 # every mark of an eager decode
    assert graphs._open_marks is None
    assert list(graphs.stage_log) == []


@pytest.mark.parametrize("arch,kernel", [
    ("llama3-8b", "repro.kernel.flash_attention"),
    ("mamba2-370m", "repro.kernel.ssd_scan")])
def test_server_spans_nest_under_the_profiler(arch, kernel):
    """The CPU server's prefill holds its kernel entry points' ranges;
    its eager decode holds one ``repro.serve.step`` a token, inside it
    one ``repro.kernel.ssm_step`` a Mamba2 layer and one
    ``repro.kernel.decode_attention`` an attention layer, and none of a
    graph's (capture, copies, replays)."""
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    server = ProgressiveServer(cfg, params, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (_B, _S),
                           generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, caches = server.prefill(prompt, _S + _G)
        server.decode(prompt[:, -1:], caches, _S, _G)
    ranges = _ranges(prof)
    top = [(n, p) for n, _, _, p in ranges if p is None]
    assert top == [("repro.serve.prefill", None),
                   ("repro.serve.decode", None)]
    kernels = [r for r in ranges if r[0] == kernel]
    assert len(kernels) == cfg.num_layers
    assert all(p == "repro.serve.prefill" for *_, p in kernels)
    steps = [r for r in ranges if r[3] == "repro.serve.decode"]
    assert [r[0] for r in steps] == ["repro.serve.step"] * _G
    (_, d0, d1, _), = [r for r in ranges if r[0] == "repro.serve.decode"]
    assert all(d0 <= s0 <= s1 <= d1 for _, s0, s1, _ in steps)
    kinds = [k for unit, reps in T.block_groups(cfg) for k in unit * reps]
    ssm_steps = [r for r in ranges if r[0] == "repro.kernel.ssm_step"]
    assert len(ssm_steps) == _G * kinds.count("ssm")
    attends = [r for r in ranges
               if r[0] == "repro.kernel.decode_attention"]
    assert len(attends) == _G * sum(k in ("dense", "moe") for k in kinds)
    assert all(p == "repro.serve.step" for *_, p in ssm_steps + attends)
    assert len(ranges) == (2 + cfg.num_layers + _G + len(ssm_steps)
                           + len(attends))
    assert list(graphs.stage_log) == []     # eager: no stage times


@pytest.mark.parametrize("arch,kernel", [
    ("mamba2-370m", "repro.kernel.ssd_scan"),
    ("llama3-8b", "repro.kernel.flash_attention")])
def test_eager_train_step_spans_its_kernels(arch, kernel):
    """An eager train step under the profiler: one kernel range a layer
    in the forward and one more where the backward recomputes the layer
    (``remat_policy``: the kernel's own backward runs the plain version
    outside the entry point), and no graph ranges."""
    cfg = registry.get_smoke_config(arch)
    step, args = _train_step(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*args)
    names = [n for n, *_ in _ranges(prof)]
    calls = cfg.num_layers * (1 if cfg.remat_policy == "none" else 2)
    assert names == [kernel] * calls


def test_no_span_is_entered_and_nothing_logged_without_the_profiler(
        monkeypatch):
    """With no profiler running, a prefill, an eager decode and an eager
    train step enter no ``record_function`` (counted at its
    ``__enter__``, wherever it is named from) and log no stage time."""
    entered = []
    real = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(record_function, "__enter__", counting)
    assert not graphs.recording()
    _serve("llama3-8b")
    _serve("mamba2-370m")
    step, args = _train_step("mamba2-370m")
    step(*args)
    assert entered == []
    assert list(graphs.stage_log) == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert graphs.recording()
        with graphs.span("repro.test"):
            pass
    assert entered == ["repro.test"]        # the count sees a span


class _Event:
    """A stand-in timing event at ``t`` ms."""

    def __init__(self, t):
        self.t, self.waited = t, False

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        self.waited = True


class _Graph:
    """A stand-in graph that counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_stages_sum_by_name_from_the_previous_mark():
    """A read gives each stage the time from the previous mark, summed by
    name in seconds, after waiting on the last mark."""
    marks = [("start", _Event(0.0)), ("embed", _Event(0.5)),
             ("mixer", _Event(2.5)), ("ffn", _Event(6.5)),
             ("mixer", _Event(7.5)), ("ffn", _Event(11.5)),
             ("norm", _Event(12.0))]
    got = graphs.stages(marks)
    assert marks[-1][1].waited
    assert got == pytest.approx({"embed": 5e-4, "mixer": 3e-3, "ffn": 8e-3,
                                 "norm": 5e-4})
    assert graphs.stages(marks[:1]) == {}


def test_the_marked_graph_replays_and_logs_only_while_profiling(
        monkeypatch):
    """``Recorded.replay`` runs the plain graph and returns its outputs
    with the profiler off, the marked one with it on; stage times are
    logged only after a marked replay, while the profiler records."""
    marks = (("start", _Event(0.0)), ("head", _Event(3.0)),
             ("sample", _Event(3.25)))
    rec = graphs.Recorded(_Graph(), "plain", _Graph(), "marked", marks,
                          pool_bytes=0, capture_seconds=0.0)
    assert rec.replay() == "plain"
    rec.log_stages("serve.decode")
    assert (rec.graph.replays, rec.marked.replays) == (1, 0)
    assert list(graphs.stage_log) == []
    profiling = [True]
    monkeypatch.setattr(graphs, "recording", lambda: profiling[0])
    rec.log_stages("serve.decode")          # the last replay was plain
    assert list(graphs.stage_log) == []
    assert rec.replay() == "marked"
    assert (rec.graph.replays, rec.marked.replays) == (1, 1)
    rec.log_stages("serve.decode")
    assert list(graphs.stage_log) == [
        {"step": "serve.decode",
         "stages": pytest.approx({"head": 3e-3, "sample": 2.5e-4})}]
    profiling[0] = False
    rec.log_stages("serve.decode")
    bare = graphs.Recorded(_Graph(), "plain", _Graph(), "marked",
                           marks[:1], pool_bytes=0, capture_seconds=0.0)
    profiling[0] = True
    bare.replay()
    bare.log_stages("train")                # only the capture's own mark
    assert len(graphs.stage_log) == 1


def test_stage_log_is_bounded():
    for i in range(graphs.stage_log.maxlen + 5):
        graphs.stage_log.append({"step": "train", "stages": {"i": i}})
    assert len(graphs.stage_log) == graphs.stage_log.maxlen
    assert graphs.stage_log[-1]["stages"]["i"] == graphs.stage_log.maxlen + 4


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    """The card to run on; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) device")
    return torch.device("cuda", 0)


def _replay_ms(replay, reps=5):
    """CUDA-event ms of ``replay()``, the last of ``reps`` calls, each
    timed alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_marked_graph_decode_equals_eager(hopper, arch):
    """The decode's plain graph, and its marked one under the profiler,
    give the eager decode's tokens; the marked graph holds the capture's
    mark, ``embed``, the layers' ``mixer`` and ``ffn`` marks, ``norm``,
    ``head`` and ``sample``; a profiled decode logs its stages, an
    unprofiled one nothing."""
    server, prompt, got = _serve(arch, hopper)
    cfg = server.cfg
    eager = ProgressiveServer(cfg, server.params, device=hopper,
                              graphs=False)
    _, caches = eager.prefill(prompt, _S + _G,
                              **T.stub_extras(cfg, _B, hopper, seed=2))
    want, _ = eager.decode(prompt[:, -1:], caches, _S, _G)
    assert torch.equal(got, want)
    (graph,) = server._graphs.values()
    names = [n for n, _ in graph.rec.marks]
    kinds = [k for unit, reps in T.block_groups(cfg) for _ in range(reps)
             for k in unit]
    assert names[:2] == ["start", "embed"]
    assert names[-3:] == ["norm", "head", "sample"]
    assert names.count("mixer") == len(kinds) + kinds.count("cross")
    assert names.count("ffn") == sum(k != "ssm" for k in kinds)
    assert list(graphs.stage_log) == []
    _, caches = server.prefill(prompt, _S + _G,
                               **T.stub_extras(cfg, _B, hopper, seed=2))
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = server.decode(prompt[:, -1:], caches, _S, _G)
    assert torch.equal(traced, want)
    assert len(server.graph_log) == 1
    (entry,) = graphs.stage_log
    assert entry["step"] == "serve.decode"
    assert set(entry["stages"]) == set(names[1:])
    assert all(v > 0 for v in entry["stages"].values())
    server.close()


@pytest.mark.cuda
def test_decode_stages_sum_to_the_replay(hopper):
    """yi-6b at its published width, cut to four layers, batch 8: the
    stages of one replay of the marked graph sum to within 3 % of a
    CUDA-event pair around that replay."""
    cfg = dataclasses.replace(registry.get_config("yi-6b"), num_layers=4)
    params = T.init_params(cfg, seed=0, device=hopper)
    server = ProgressiveServer(cfg, params, device=hopper)
    prompt = torch.randint(0, cfg.vocab_size, (8, 256), device=hopper)
    _, caches = server.prefill(prompt, 256 + 8)
    server.decode(prompt[:, -1:], caches, 256, 2)
    (graph,) = server._graphs.values()

    def replay():
        graph.start(prompt[:, -1:], 256)
        graph.rec.marked.replay()

    whole = _replay_ms(replay)
    parts = graphs.stages(graph.rec.marks)
    total = 1e3 * sum(parts.values())
    print(f"yi-6b x4 decode replay {whole:.4f} ms; stages "
          f"{ {k: round(1e3 * v, 4) for k, v in parts.items()} }")
    assert set(parts) == {"embed", "mixer", "ffn", "norm", "head", "sample"}
    assert abs(total - whole) <= 0.03 * whole
    server.close()


@pytest.mark.cuda
def test_train_stages_sum_to_the_replay(hopper):
    """A graphed mamba2-370m train step (published width, four layers,
    2 x 512 tokens): forward, backward, optimizer and the write-back of
    the donated parameters and state, in one replay of the marked graph,
    sum to within 3 % of a CUDA-event pair around that replay, and a
    profiled call logs them as ``train``."""
    step, args = _train_step("mamba2-370m", hopper, graphed=True,
                             num_layers=4, batch=2, seq=512)
    params, opt, batch = args
    params, opt, _ = step(params, opt, batch)
    (cap,) = step._captures.values()
    whole = _replay_ms(cap.rec.marked.replay)
    parts = graphs.stages(cap.rec.marks)
    total = 1e3 * sum(parts.values())
    print(f"mamba2-370m x4 train replay {whole:.4f} ms; stages "
          f"{ {k: round(1e3 * v, 4) for k, v in parts.items()} }")
    assert list(parts) == ["forward", "backward", "optimizer", "writeback"]
    assert abs(total - whole) <= 0.03 * whole
    assert list(graphs.stage_log) == []
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, opt, batch)
    (entry,) = graphs.stage_log
    assert entry["step"] == "train" and list(entry["stages"]) == list(parts)
