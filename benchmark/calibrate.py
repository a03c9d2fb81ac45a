"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds 3

For each seed, in one process: one run of the cell with a short window,
whose check gives the program's readings (the lower readings); for each
control seed, the control also, the plain reference one precision step
below the configuration's (``Reference(precision="control")``: fp8 network
products, float32 ground, a bfloat16 search and bfloat16-rounded FFTs) put
in the program's place on the same map scans, weights, draws and sampled
queries, and held to the exact reference by the same comparison (the upper
readings). Prints one JSON line per reading and, last, each number's
largest program reading and smallest control reading. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]


def control_readings(keep: dict, seed: int, device) -> dict:
    """The control in the program's place: its own map and its own answers
    to the program's sampled queries, held to the exact reference."""
    import numpy as np

    from lbench import cell, check, program, world
    from lbench.reference.pipeline import Reference

    cfg, scene, traffic = keep["cfg"], keep["scene"], keep["traffic"]
    ctl = Reference(cfg, keep["params"], device, "control")
    step = traffic["map"]["build_batch"]
    seeds = [world.draw_seed(seed, 0, j)
             for j in range(-(-len(scene.kf_scans) // step))]
    m = ctl.build_map(scene.kf_scans, scene.kf_masks, seeds, step,
                      keep["filler"])
    state = check.MapState(m["bank"], m["image"], m["origin"],
                           m["rot"].cpu().numpy(), m["trans"].cpu().numpy())
    units = []
    for u in keep["sample"]:
        out = ctl.locate(scene.q_scans[u.pool], scene.q_masks[u.pool],
                         u.draw_seed, m)
        answers = []
        for i, (ok, db, score, xy_yaw, pose) in enumerate(out["results"]):
            answers.append(check.Answer(
                ok, db, np.asarray(out["candidates"][i]),
                out["d2"][i].cpu().numpy(), score, xy_yaw,
                None if pose is None else pose[0],
                None if pose is None else pose[1]))
        units.append(program.Unit(u.index, u.pool, u.draw_seed, 0.0,
                                  answers))
    return cell.reference_readings(cfg, keep["params"], scene, traffic,
                                   seed, device, keep["filler"], state,
                                   units)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from lbench import cell, check

    if not torch.cuda.is_available():
        print("no NVIDIA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        line = cell.run(args.workload, seed, args.seconds, False,
                        "cuda", keep=keep,
                        log=lambda m: print(m, file=sys.stderr))
        got = {k: v["value"] for k, v in line["check"].items()}
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": line["correct"], "readings": got}),
              flush=True)
        for k, v in got.items():
            low[k] = max(low.get(k, 0.0), v)
        if seed in control:
            ctl = control_readings(keep, seed, torch.device("cuda"))
            print(json.dumps({"seed": seed, "side": "control",
                              "readings": ctl}), flush=True)
            for k, v in ctl.items():
                high[k] = min(high.get(k, float("inf")), v)
    print(json.dumps({"lower": low, "upper": high,
                      "names": list(check.NAMES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
