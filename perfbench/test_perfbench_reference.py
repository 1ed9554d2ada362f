"""The plain references against the port's CPU path at smoke sizes, and
a run of the harness on the CPU: sound, it comes out correct; with the
timed path broken underneath, not."""

import pytest

torch = pytest.importorskip("torch")

from perfbench import run as bench_run  # noqa: E402
from perfbench import serving, training  # noqa: E402
from perfbench.reference.common import Precision, released_weight  # noqa: E402


def _close(a, b, tol):
    return ((a - b).abs().max() / b.abs().max()).item() < tol


@pytest.mark.parametrize("cell", ["yi-6b.chat", "mamba2-370m.first-res"])
def test_reference_forward_matches_the_port_in_float32(smoke_cell, cell):
    from repro_torch.models import transformer as T
    ctx, _ = smoke_cell(cell, compute_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, ctx["model"]["vocab_size"], (24,),
                           generator=gen)
    with torch.no_grad():
        want, _ = T.forward(ctx["params"], tokens[None], ctx["cfg"])
        ref = ctx["reference"]
        h = ref.hidden(ctx["params"], tokens, ctx["model"], Precision())
        got = h @ ref.head_weight(ctx["params"], ctx["model"])
    assert _close(got, want[0], 1e-4)


@pytest.mark.parametrize("release", [1, 2])
def test_released_head_matches_the_port_resolution_series(release):
    from repro_torch.core import progressive
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((64, 300), generator=gen) * 0.1
    x = torch.randn((7, 64), generator=gen)
    series = progressive.resolution_series(
        progressive.make_layered_linear(w, m=2, d=7), x)
    assert _close(x @ released_weight(w, 2, 7, release),
                  series[release - 1], 1e-5)


def test_train_reference_follows_the_port_in_float32(smoke_cell):
    ctx, c = smoke_cell("mamba2-370m.train", compute_dtype="float32")
    rec = training.run(ctx)
    readings = training.check(rec, ctx)
    assert readings["loss_gap"] < 1e-5
    assert readings["grad_gap"] < 1e-3
    assert readings["grad_diff"] < 1e-3
    assert readings["change_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["yi-6b.chat", "mamba2-370m.first-res",
                                  "yi-6b.long-prompt", "mamba2-370m.train"])
def test_sound_run_is_correct(smoke_cell, cell):
    ctx, c = smoke_cell(cell)
    rec, metrics = bench_run.measure(bench_run_manifest(), c, ctx)
    assert "setup_s" in metrics
    correct, checks = bench_run.judge(rec, ctx, c["limits"])
    assert correct, checks


def bench_run_manifest():
    from perfbench import manifest as mf
    return mf.load()


def _altered_decode(monkeypatch):
    from repro_torch.launch.serve import ProgressiveServer
    real = ProgressiveServer.decode

    def decode(self, *args, **kw):
        out, stats = real(self, *args, **kw)
        out = out.clone()
        # every request's last token of the call, so the sample meets one
        out[:, -1] = (out[:, -1] + 1) % self.cfg.vocab_size
        return out, stats

    monkeypatch.setattr(ProgressiveServer, "decode", decode)


def _broken_step(monkeypatch, fault):
    from repro_torch.launch import steps as steps_lib
    real = steps_lib.make_train_step

    def make(cfg, tcfg):
        step, optimizer = real(cfg, tcfg)

        def broken(params, opt, batch):
            if fault == "half_batch":
                half = batch["tokens"].shape[0] // 2
                return step(params, opt, {k: v[:half]
                                          for k, v in batch.items()})
            new, new_opt, metrics = step(params, opt, batch)
            return params, new_opt, metrics       # the state left unchanged

        return broken, optimizer

    monkeypatch.setattr(steps_lib, "make_train_step", make)


@pytest.mark.parametrize("cell,fault", [
    ("yi-6b.chat", "token_altered"),
    ("mamba2-370m.first-res", "token_altered"),
    ("yi-6b.long-prompt", "token_altered"),
    ("mamba2-370m.train", "state_unchanged"),
    ("mamba2-370m.train", "half_batch")])
def test_broken_timed_path_is_not_correct(smoke_cell, monkeypatch, cell,
                                          fault):
    ctx, c = smoke_cell(cell)
    if fault == "token_altered":
        _altered_decode(monkeypatch)
    else:
        _broken_step(monkeypatch, fault)
    rec, _ = bench_run.measure(bench_run_manifest(), c, ctx)
    correct, checks = bench_run.judge(rec, ctx, c["limits"])
    assert not correct, checks


@pytest.mark.parametrize("cell", ["yi-6b.chat", "mamba2-370m.first-res",
                                  "mamba2-370m.train"])
def test_control_reads_far_above_the_program(smoke_cell, cell):
    """The fp8 control at smoke size reads at least three times what the
    program does (the chip-size control is ``test_perfbench_card.py``)."""
    ctx, c = smoke_cell(cell)
    rec, _ = bench_run.measure(bench_run_manifest(), c, ctx)
    kind = serving if c["traffic"]["kind"] == "serve" else training
    program = kind.check(rec, ctx)
    control = kind.check(rec, ctx, control=True)
    assert max(control[k] / max(program[k], 1e-6) for k in program) >= 3.0
