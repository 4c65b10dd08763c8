"""
d=16 benchmark: full Runner loops on the d-dimensional random Gaussian.

The reference's applicability envelope is d <~ 20 (reference
README.rst:60-64).  Each seed runs through ``gpry_tpu.run.run_resilient``
(checkpoint-reload-retry after a runtime failure), one seed after the
other in this one process, so that only one process holds the device.

Usage: python benchmarks/d16.py [--d 16] [--seeds 100,101,102]
Writes benchmarks/results_d{d}.json (merged run by run).
"""

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))


def run_one(d, seed, ckpt_root, verbose=2):
    """One seed, resumed from its checkpoint when a complete one exists."""
    import numpy as np
    from model_generator import kl_truth_gaussian, random_gaussian

    from gpry_tpu.io import check_checkpoint
    from gpry_tpu.run import run_resilient

    ckpt = os.path.join(ckpt_root, f"d{d}_s{seed}")
    resume = bool(np.all(check_checkpoint(ckpt)))
    m = random_gaussian(d=d, rng=seed)
    t0 = time.time()
    # on resume, omit seed so the Runner continues the CHECKPOINTED rng
    # stream instead of replaying it from the start
    runner = run_resilient(
        m.loglike, bounds=m.bounds, verbose=verbose,
        seed=None if resume else seed, checkpoint=ckpt, max_retries=4,
        load_checkpoint="resume" if resume else "overwrite",
        gp_acquisition={"NORA": {}})
    X, w, _ = runner.last_mc_samples()
    return {
        "d": d,
        "seed": seed,
        "converged": bool(runner.has_converged),
        "n_total": int(runner.gpr.n_total),
        "n_finite": int(runner.gpr.n),
        "kl_final": float(kl_truth_gaussian(X, w, m.mean, m.cov)),
        "wall_s": round(time.time() - t0, 1),
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--seeds", default="100,101,102")
    ap.add_argument("--verbose", type=int, default=2)
    ap.add_argument("--ckpt-root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ckpt_d16"))
    args = ap.parse_args()
    seeds = tuple(int(x) for x in args.seeds.split(","))

    import jax
    dev = jax.devices()[0]
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            f"results_d{args.d}.json")
    # merge across invocations: keep committed rows for seeds not being
    # re-run (a prior --seeds 100,101 file must survive a --seeds 102 run)
    rows = []
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                rows = [r for r in json.load(f).get("runs", [])
                        if r.get("seed") not in seeds]
        except (OSError, ValueError, KeyError):
            rows = []
    for seed in seeds:
        row = run_one(args.d, seed, args.ckpt_root, verbose=args.verbose)
        rows.append(row)
        print(json.dumps(row), flush=True)
        summary = {
            "d": args.d,
            "engine": "gpry_tpu(NORA) via run_resilient",
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "evals_to_stop": [r["n_total"] for r in rows],
            "kl_final": [r["kl_final"] for r in rows],
            "n_converged": int(sum(r["converged"] for r in rows)),
            "n_runs": len(rows),
            "wall_s": [r["wall_s"] for r in rows],
            "runs": rows,
        }
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    print(f"-> {out_path}")
