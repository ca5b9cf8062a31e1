"""The readings that the comparison's limits were set from, at a cell's own
size on the card:

    python3 portbench/control.py --workload <cell> --seeds 11,22,33
        [--readings program,control,half_batch]

For each seed it builds the cell's inputs as a run does and reads each
number the comparison reads, of:

* ``program``: the program as a run drives it, up to what the comparison
  follows (serving: the server loaded once for all seeds, each seed's
  check batch served; training: the trainer built and warm-started, its
  three set-up steps), judged against the reference: the lower readings;
* ``control``: the plain reference put in the program's place, one
  precision step below what the configuration states (its products and
  convolutions in float8 e4m3 with a scale a tensor, where the releases
  state bfloat16; the preprocessing in TF32, where the program computes in
  float32);
* training cells, ``half_batch``: the reference stepping on the first half
  of each batch, the mean taken over it, with the same masks and jitter
  for those rows (a step that returns its state unchanged reads 1 on
  ``update_gap`` by the measure itself and needs no run).

Each reading goes through the harness's own decision (``harness.decide``)
with the cell's limits. It prints one JSON line a seed and reading, and
exits with 1 where a control or a fault came out correct. The benchmark's
runs do not run it; ``tests/test_portbench_control.py`` runs it at a small
size."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FAULTS = ("control", "half_batch")


def serve_readings(cell, seed, device, assets_dir, which, log=print,
                   shared=None) -> dict:
    """``shared`` (a dict kept across seeds) holds the loaded server."""
    import torch

    from portbench.drivers.serve import Driver
    from portbench.ref import model as M
    from portbench.ref import serve as RS

    shared = {} if shared is None else shared
    drv = Driver(cell, seed, device, assets_dir, log)
    drv.render_batches()
    out = {}
    if "program" in which:
        first = "srv" not in shared
        drv.load_server(shared.get("srv"))
        shared["srv"] = drv.srv
        if first:
            drv.warm(*(torch.from_numpy(a).to(device)
                       for a in drv.batch[:2]))
        drv.serve_checked(*(torch.from_numpy(a).to(device)
                            for a in drv.check_batch[:2]))
    ref = drv.reference()
    if "program" in which:
        out["program"] = drv.judge(drv.served_batch(), ref)
    if "control" in which:
        ctl = drv.reference(M.Prec("tf32"), M.Prec("fp8"))
        out["control"] = drv.judge(RS.served_from_reference(ctl), ref)
    return out


def train_readings(cell, seed, device, assets_dir, which, log=print,
                   shared=None) -> dict:
    import torch

    from portbench.drivers.train import Driver, compare
    from portbench.ref import model as M

    drv = Driver(cell, seed, device, assets_dir, log)
    out = {}
    if "program" in which:
        drv.setup()
        drv.release()
    else:
        drv._batches()
    P0, ref = drv.reference()
    if "program" in which:
        out["program"] = compare(drv.losses, drv.g1, drv.p0, drv.p3, *ref)
    half = torch.arange(cell.traffic["B"] // 2, device=device)
    for name, prec, rows in (("control", M.Prec("fp8"), None),
                             ("half_batch", M.Prec(), half)):
        if name in which:
            _, got = drv.reference(prec, rows)
            out[name] = compare(got[0], got[1], P0, {
                k: P0[k] + got[2][k] for k in P0}, *ref)
    return out


def readings(cell, seed, device, assets_dir, which=("control", "half_batch"),
             log=print, shared=None) -> dict:
    """-> {reading: the comparison's numbers} of ``which`` (serving cells
    have no ``half_batch``)."""
    fn = (serve_readings if cell.traffic["driver"] == "serve"
          else train_readings)
    return fn(cell, seed, device, assets_dir, which, log, shared)


def main(argv=None) -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--readings", default="program,control,half_batch")
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    which = tuple(a.readings.split(","))
    dev = torch.device("cuda")
    print(harness.device_label(dev), file=sys.stderr)
    shared, passed = {}, []
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), dev, str(harness.ROOT / "assets"), which,
                     log=lambda m: print(m, file=sys.stderr), shared=shared)
        for name, nums in r.items():
            checks, correct = harness.decide(nums, cell.limits)
            if name in FAULTS and correct:
                passed.append((int(s), name))
            print(json.dumps({"workload": a.workload, "seed": int(s),
                              "reading": name, "correct": correct,
                              "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    if passed:
        print(f"controls or faults that came out correct: {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
