"""The benchmark's tests: the CPU ones run anywhere; those marked
``cuda`` need an NVIDIA Hopper card and skip elsewhere, deciding in a
fixture."""

import pathlib

import pytest


def pytest_collection_modifyitems(config, items):
    """Run this folder's tests after every other file's.  With
    ``--dist loadfile`` the workers take files in collection order, and
    which of the reference's order-dependent cases pass (ROADMAP R1: a
    trace cached by an earlier file in the same worker) depends on which
    files a worker ran before; collected last, these tests leave that
    order as it was without them."""
    here = pathlib.Path(__file__).resolve().parent
    ours = [i for i in items if here in i.path.parents]
    if ours:
        items[:] = [i for i in items if here not in i.path.parents] + ours


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper GPU and nvcc (the PyTorch "
        "port's kernels); skips elsewhere")


@pytest.fixture
def hopper():
    """The card to run on; decided here, never at import."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) device")
    return torch.device("cuda", 0)


#: the smoke sizes of each family: every width cut, for a CPU run
SMOKE = {
    "dense": {"num_layers": 2, "d_model": 64, "d_ff": 160, "vocab_size": 512,
              "attention": {"num_heads": 4, "num_kv_heads": 2,
                            "head_dim": 16}},
    "ssm": {"num_layers": 2, "d_model": 64, "vocab_size": 512,
            "ssm": {"d_state": 16, "head_dim": 16, "chunk_size": 8}},
}
SMOKE_TRAFFIC = {"serve": {"batch": 3, "prompt": 16, "gen": 5,
                           "trace_decode_steps": 2},
                 "train": {"batch": 2, "seq": 16}}


@pytest.fixture
def smoke_cell():
    """``make(cell, seed, compute_dtype=None)``: the context of a run of
    ``cell`` on the CPU at its family's smoke sizes (the cell's traffic,
    limits and reference, every size cut), and the cell's files."""
    torch = pytest.importorskip("torch")
    import copy
    import time

    from perfbench import manifest as mf
    from perfbench.run import context

    def make(name, seed=20240601, compute_dtype=None, seconds=0.5):
        files = mf.cell(mf.load(), name)
        c = copy.deepcopy({k: v for k, v in files.items()
                           if k != "reference"})
        c["reference"] = files["reference"]
        model = c["config"]["model"]
        for k, v in SMOKE[model["family"]].items():
            if isinstance(v, dict):
                model[k].update(v)
            else:
                model[k] = v
        if compute_dtype:
            model["compute_dtype"] = compute_dtype
        c["traffic"].update(SMOKE_TRAFFIC[c["traffic"]["kind"]])
        ctx = context(c, seed, seconds, False, torch.device("cpu"),
                      time.perf_counter())
        return ctx, c

    return make
