"""The readers of the per-stage device times: each reads its stage from the
newest ``repro_torch.launch.graphs.stage_log`` entry of its step, in ms,
and finds nothing (``None``) where no entry or no such stage is there."""

import pytest

from perfbench import manifest as mf

pytest.importorskip("torch")

from repro_torch.launch import graphs  # noqa: E402

READERS = [("decode_mixer_device_ms", "serve.decode", "mixer"),
           ("decode_ffn_device_ms", "serve.decode", "ffn"),
           ("decode_head_device_ms", "serve.decode", "head"),
           ("train_forward_device_ms", "train", "forward"),
           ("train_backward_device_ms", "train", "backward"),
           ("train_optimizer_device_ms", "train", "optimizer")]


@pytest.fixture
def stage_log():
    graphs.stage_log.clear()
    yield graphs.stage_log
    graphs.stage_log.clear()


@pytest.mark.parametrize("name,step,stage", READERS)
def test_reader_takes_the_newest_entry_of_its_step(stage_log, name, step,
                                                   stage):
    read = mf.reader(name)
    rec = {"trace": {"ranges": {}}}
    assert read(rec, {}) is None
    stage_log.append({"step": step, "stages": {stage: 0.004}})
    stage_log.append({"step": step, "stages": {stage: 0.0125, "x": 1.0}})
    other = "train" if step == "serve.decode" else "serve.decode"
    stage_log.append({"step": other, "stages": {stage: 9.0}})
    assert read(rec, {}) == pytest.approx(12.5)
    stage_log.append({"step": step, "stages": {"embed": 0.001}})
    assert read(rec, {}) is None        # the newest entry lacks the stage


def test_each_reader_is_a_program_span_in_the_manifest():
    entries = {m["name"]: m for m in mf.load()["per_layer"]}
    for name, step, _ in READERS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        moves = "tpot_ms" if step == "serve.decode" else "train_tokens_per_s"
        assert m["moves"] == moves
