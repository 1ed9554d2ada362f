"""On the card: the fp8 control at a cell's own size, on three seeds,
fails the cell's limits while the program passes them (the readings the
limits were set from are in ``PERF.md``).  Skips without a Hopper card.

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/test_perfbench_card.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

CELLS = ["yi-6b.chat", "mamba2-370m.first-res", "yi-6b.long-prompt",
         "mamba2-370m.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_cell_size(hopper, cell):
    import time

    from perfbench import manifest as mf
    from perfbench.calibrate import readings
    from perfbench.run import context, driver
    c = mf.cell(mf.load(), cell)
    limits = c["limits"]
    for seed in (7001, 7002, 7003):
        ctx = context(c, seed, 0.01, False, hopper, time.perf_counter())
        rec = driver(c["traffic"]["kind"]).run(ctx)
        torch.cuda.empty_cache()
        r = readings(ctx, rec)
        assert all(r["program"][k] <= limits[k] for k in limits), r
        assert any(r["control"][k] > limits[k] for k in limits), r
        del ctx, rec
        torch.cuda.empty_cache()
