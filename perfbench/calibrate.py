"""The readings a cell's limits are set from, on the card, in one process:

    python3 perfbench/calibrate.py --workload yi-6b.chat \\
        --seeds 11,12,13 --seconds 0.01

For each seed it draws the weights, sets the cell up and runs a window of
``--seconds`` (at least one whole batch or step, at the cell's own
sizes), then reads the numbers that decide ``correct`` three ways: of the
program (the lower readings), of the control (the plain reference
computed in fp8 in the program's place: the upper readings), and of the
faults the cell can have, planted (a served token altered where it is
produced; a train step's loss taken over half the batch; a train state
left unchanged reads 1 and needs no run).  One JSON line a seed, then
one with the largest program reading and the smallest control and fault
readings of each number.  The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time


def readings(ctx: dict, rec: dict) -> dict:
    """Program, control and fault readings of one set-up run."""
    from perfbench import serving, training
    from perfbench.reference.common import Precision
    if ctx["traffic"]["kind"] == "serve":
        program = serving.check(rec, ctx)
        control = serving.check(rec, ctx, control=True)
        altered = dict(rec, outputs=[o.clone() for o in rec["outputs"]])
        last = altered["outputs"][-1]
        # the last request's third released token, moved to the next id
        last[-1, 3] = (last[-1, 3] + 1) % ctx["model"]["vocab_size"]
        faults = {"token_altered": serving.check(altered, ctx)}
        return {"program": program, "control": control, "faults": faults}
    ref = training.reference_readings(ctx, Precision("fp32"))
    control = training.compare(
        training.reference_readings(ctx, Precision("fp8")), ref)
    half = training.compare(training.reference_readings(
        ctx, Precision("fp32"), half_batch=True), ref)
    return {"program": training.compare(rec, ref), "control": control,
            "faults": {"half_batch": half}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=0.01)
    args = ap.parse_args(argv)
    from perfbench.run import bootstrap
    bootstrap()
    import torch

    from perfbench import manifest as mf
    from perfbench.run import context, driver
    c = mf.cell(mf.load(), args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = context(c, seed, args.seconds, False, device, t0)
        rec = driver(c["traffic"]["kind"]).run(ctx)
        torch.cuda.empty_cache()
        row = dict(readings(ctx, rec), seed=seed,
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ctx, rec
        torch.cuda.empty_cache()
    summary = {}
    for key, pick in (("program", max), ("control", min)):
        summary[key] = {n: pick(r[key][n] for r in rows)
                        for n in rows[0][key]}
    summary["faults"] = {f: {n: min(r["faults"][f][n] for r in rows)
                             for n in rows[0]["faults"][f]}
                         for f in rows[0]["faults"]}
    print(json.dumps({"summary": summary, "seeds": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)
    raise SystemExit(main())
