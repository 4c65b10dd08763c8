"""
d=16 final-MC knob study (VERDICT round-4 item 1 fallback).

The round-5 d=16 rerun with the round-4/5 accuracy stack converges on
every seed, but the final KL straddles the 0.05 gate (seed 100: 0.047,
seed 101: 0.057) and on both seeds the mixture-IS refinement kept the
input sample (its ``min_gain=2.0`` ESS-doubling acceptance rule never
fired at this dimension).  The active-learning loop is NOT the limiter —
the final sample is.  This driver re-runs ONLY the final MC from the
campaign's saved checkpoints, sweeping the knobs the VERDICT names:

* ``nlive`` of the device nested sampler (default 50d,
  gpry/run.py:1660), and
* the IS-refinement acceptance (``min_gain``: accept a refined sample
  whenever its ESS merely matches the input, instead of doubling it).

Each row re-measures the same analytic-moments KL as benchmarks/d16.py,
so rows are directly comparable to results_d{d}.json.

Writes benchmarks/results_d16_knobs.json.

Usage:
  python benchmarks/d16_knobs.py [--d 16] [--seeds 100,101,102]
      [--ckpt-root benchmarks/ckpt_d16] [--nlives 50d,100d,200d]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def knob_rows(d, seed, ckpt, nlives, verbose=1):
    from model_generator import kl_truth_gaussian, random_gaussian

    from gpry_tpu.mc.refine import is_refine_sample
    from gpry_tpu.run import Runner

    m = random_gaussian(d=d, rng=seed)
    runner = Runner(m.loglike, bounds=m.bounds, verbose=verbose,
                    checkpoint=ckpt, load_checkpoint="resume",
                    gp_acquisition={"NORA": {}})
    rows = []
    for nlive in nlives:
        t0 = time.time()
        res = runner.generate_mc_sample(add_options={"nlive": nlive})
        base = {
            "d": d, "seed": seed, "nlive": nlive,
            "n_total": int(runner.gpr.n_total),
            "kl_ns": float(kl_truth_gaussian(
                res["X"], res["weights"], m.mean, m.cov)),
            "wall_s_ns": round(time.time() - t0, 1),
        }
        # refinement sweep on the SAME NS sample: the default doubling
        # rule vs an any-improvement rule
        for min_gain, tag in ((2.0, "refine_2x"), (1.0, "refine_1x")):
            t1 = time.time()
            ref = is_refine_sample(runner.gpr, res, m.bounds,
                                   rng=np.random.default_rng(seed),
                                   min_gain=min_gain, verbose=verbose)
            base[tag] = {
                "refined": bool(ref.get("refined", False)),
                "ess": float(ref.get("ess", np.nan)),
                "kl": float(kl_truth_gaussian(
                    ref["X"], ref["weights"], m.mean, m.cov)),
                "wall_s": round(time.time() - t1, 1),
            }
        rows.append(base)
        print("KNOB-RESULT: " + json.dumps(base), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--seeds", default="100,101,102")
    ap.add_argument("--ckpt-root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ckpt_d16"))
    ap.add_argument("--nlives", default="50d,100d,200d")
    ap.add_argument("--verbose", type=int, default=1)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    nlives = args.nlives.split(",")
    all_rows = []
    for seed in seeds:
        ckpt = os.path.join(args.ckpt_root, f"d{args.d}_s{seed}")
        if not os.path.isdir(ckpt):
            print(f"[KNOBS] no checkpoint at {ckpt}; skipping seed {seed}",
                  flush=True)
            continue
        try:
            all_rows.extend(knob_rows(args.d, seed, ckpt, nlives,
                                      verbose=args.verbose))
        except Exception as exc:  # keep sweeping the other seeds
            print(f"[KNOBS] seed {seed} failed: {exc!r}", flush=True)
            all_rows.append({"d": args.d, "seed": seed,
                             "error": repr(exc)})
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       f"results_d{args.d}_knobs.json")
    with open(out, "w") as f:
        json.dump({"rows": all_rows,
                   "note": "final-MC knob study from the campaign "
                           "checkpoints; kl_ns is directly comparable to "
                           f"results_d{args.d}.json kl_final"},
                  f, indent=1, default=float)
    print(f"-> {out}")


if __name__ == "__main__":
    main()
